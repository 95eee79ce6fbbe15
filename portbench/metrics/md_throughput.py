"""Atom-steps a second completed in the window, in millions: atoms x MD
steps over the window's host seconds, which end with a synchronise."""


def read(run):
    return run.values.get("md_throughput")
