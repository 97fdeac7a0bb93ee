"""The share of the traced window in which nothing ran on the card."""

from benchmark.layers._common import idle_pct


def read(run):
    return idle_pct(run, "train")
