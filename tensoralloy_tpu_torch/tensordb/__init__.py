"""tensordb — training-database generation pipeline (port of
`tensoralloy_tpu/tensordb/`, after the reference's `tensordb/` package):
VASP AIMD samplers with task lifecycle, job parsing/convergence checks
(vaspkit), microstructure generators, and an MD-timestep recommender.
Host code only (numpy): nothing here runs on the card."""
from .vaspkit import VaspJob, ServiceUnit            # noqa: F401
from .md import recommend_md_timestep                # noqa: F401
from .sampler import (BaseSampler, AimdSampler,      # noqa: F401
                      VaspAimdSampler, ExistedTrajectorySampler)
from .calculator import (BaseCalculator, VaspCalculator,   # noqa: F401
                         VaspAgingCalculator,
                         VaspNonEquilibriumCalculator,
                         VaspPorousCalculator,
                         FibonacciSphereHeliumBubbleInjector)
