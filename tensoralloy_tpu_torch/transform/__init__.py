from .featurizer import Featurizer, Features  # noqa: F401
