"""Structures trained a second: batch size x steps over the window's
host seconds, which end with a synchronise."""


def read(run):
    return run.values.get("train_throughput")
