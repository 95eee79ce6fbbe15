"""Milliseconds of a train step's first backward (the forces, with
create_graph), CUDA events at the forward's end and the predictions'
end, the mean over every step of the window."""


def read(run):
    return run.values.get("first_ms")
