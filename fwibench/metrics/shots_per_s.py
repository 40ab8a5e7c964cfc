"""Shots completed in the window's whole evaluations over the window's
host time, up to its final synchronize."""


def read(run):
    if run.window_s is None:
        return None
    return run.evaluations * run.shots / run.window_s
