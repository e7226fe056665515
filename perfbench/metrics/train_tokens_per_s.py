"""Tokens of every training step completed in the window over the time
from the window's start to the last step's end (host clock)."""


def read(obs):
    return sum(r["tokens"] for r in obs.records) / obs.records[-1]["t_end"]
