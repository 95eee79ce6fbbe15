"""Share of their roofline of GRAP's descriptor kernels together
(grap_kernel and grap_vjp_kernel) in the MD window, in %."""
from portbench.trace import share_of_bound

KERNELS = {"grap": [r"\bgrap_kernel\b"],
           "grap_vjp": [r"\bgrap_vjp_kernel\b"]}


def read(run):
    return share_of_bound(run, KERNELS)
