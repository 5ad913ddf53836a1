"""Decode helpers shared by the engines (port of ray_tpu/models/decoding.py;
the dense `DecodeEngine` is not ported yet)."""

from __future__ import annotations

from typing import Tuple


def default_prefill_buckets(max_seq_len: int) -> Tuple[int, ...]:
    """Powers of two up to max_seq_len (always including it): prompts pad
    to one of these lengths, so a few shapes cover every prompt."""
    buckets = []
    b = 16
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return tuple(buckets)
