"""Percent of the traced decode slice in which no device operation ran
(the mean over the cards)."""

from harness import readers


def read(t):
    return readers.idle_share(t, "decode")
