"""Drivers: for each kind of configuration, the public entry that a window
drives, and how a request is drawn from the traffic mix and the seed. A
driver module ``<kind>.py`` holds a ``Client(config, traffic, device, seed)``
with ``draw(index)``, ``prep(req)``, ``optimize(req)``, ``readback(req)``,
``outputs(req)``, ``reference_inputs(req)`` and ``close()``; the reference
of the same name under ``holobench/reference`` takes ``reference_inputs``,
and the work count under ``holobench/work`` the shapes."""

import numpy as np
import torch


def request_seed(seed, index):
    """A 63-bit seed for request ``index`` of a run seeded ``seed`` (any
    whole number; the warm-up request is index -1)."""
    words = [int(seed) % 2**64, (int(seed) // 2**64) % 2**64, int(index) % 2**32]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def request_rng(seed, index):
    """The host generator of request ``index``'s parameters."""
    return np.random.default_rng(request_seed(seed, index))


def request_generator(seed, index, device):
    """The device generator of request ``index``'s initial phase."""
    return torch.Generator(device=device).manual_seed(request_seed(seed, index) ^ 0x5F3759DF)
