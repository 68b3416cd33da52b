"""Where the entry points run, and the drivers' engine choice.

The port's entry points run on the card unless the caller names another
device; ``resolve_device`` turns their ``device``/``dtype`` arguments into
a device and dtype, and ``check_compute_engine`` validates the
``compute_engine`` argument the drivers keep from the JAX package.
"""
from __future__ import annotations

import torch

COMPUTE_ENGINES = ("auto", "pallas", "xla")


def check_device(device):
    """Raise unless ``device`` is the CPU or CUDA with a device present:
    entry points that default to the card never carry on quietly on the
    CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain engine on the CPU")


def resolve_device(device=None, dtype=None):
    """(device, dtype) of an entry point: the card unless the caller names
    another device (raising where there is no card), float32 on the card
    and float64 elsewhere unless ``dtype`` is given."""
    device = torch.device("cuda" if device is None else device)
    check_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    return device, dtype


def check_compute_engine(engine: str, device, what: str):
    """Validate a driver's ``compute_engine`` (the JAX package's choice
    between its Pallas kernels and its XLA path).  On the card "auto" and
    "pallas" run the CUDA kernels, and "xla" raises: the XLA path has no
    counterpart there.  On the CPU every value runs the plain version."""
    if engine not in COMPUTE_ENGINES:
        raise ValueError(f"{what}: unknown compute_engine {engine!r}; the "
                         f"choices are {COMPUTE_ENGINES}")
    if engine == "xla" and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"{what}: compute_engine='xla' names the JAX package's XLA "
            "path, which has no CUDA counterpart: on the card the port "
            "runs its kernels ('auto' or 'pallas'), and device='cpu' runs "
            "the plain version")
