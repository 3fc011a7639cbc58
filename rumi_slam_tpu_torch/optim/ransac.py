"""Hypothesis draws for the RANSAC estimators (``two_view``, ``pnp``).

A draw is a callable ``draw(logits, (H, m)) -> LongTensor [H, m]`` that
picks H*m row indices, each independently with probability
``softmax(logits)``: the distribution of the JAX package's
``jax.random.categorical(key, logits[None].repeat(H * m, 0)).reshape(H, m)``.
The draws themselves differ, so a parity test passes JAX's own draws in
through a draw callable of its own.
"""

from __future__ import annotations

import math

import torch


def sampler(generator: torch.Generator):
    """Draw callable on an explicit CPU generator: the card and the CPU draw
    the same index sets from the same generator state."""

    def draw(logits, shape):
        p = torch.softmax(logits.detach().to("cpu", torch.float32), dim=0)
        idx = torch.multinomial(p, math.prod(shape), replacement=True, generator=generator)
        return idx.reshape(shape)

    return draw
