"""Seconds from the process's start to the window's start."""


def read(obs):
    return obs.setup_s
