from .models import EamAlloyNN, EamFsNN, AdpNN, model_from_dict  # noqa
from .potentials import available_potentials  # noqa: F401
