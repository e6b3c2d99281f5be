"""The dense part of the JAX package's ``lod.py``.

A LoD (ragged sequence) value arrives with the sequences slice; until
then every value is a plain tensor and ``unwrap``/``rewrap`` pass it
through.  Op rules call them anyway, so that the sequences slice can
give them a body without touching the rules.
"""

from __future__ import annotations


def unwrap(x):
    return x


def rewrap(template, data):
    return data
