"""Share of their roofline of the six symmetry-function kernels
together (G2 and G4, their VJPs and second orders) in the train window,
in %."""
from portbench.trace import share_of_bound

KERNELS = {k: [r"\b" + k + r"_kernel\b"]
           for k in ("g2", "g4", "g2_vjp", "g4_vjp", "g2_vjp_bwd",
                     "g4_vjp_bwd")}


def read(run):
    return share_of_bound(run, KERNELS)
