"""The window's useful FLOP (the descriptors' operations and the MLP's
products, frozen counts from the real entries of its inputs) over the
traced window's seconds, as a share of the card's published float32
peak, in %."""
from portbench.work.peaks import FP32_FLOP_PER_S


def read(run):
    if not run.useful_flop or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.useful_flop / run.trace.window_s / FP32_FLOP_PER_S
