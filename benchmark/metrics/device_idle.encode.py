"""Percent of the traced encode slice in which no device operation ran
(the mean over the cards)."""

from harness import readers


def read(t):
    return readers.idle_share(t, "encode")
