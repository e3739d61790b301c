"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the
sharding tests have a mesh without any accelerator. When JAX_PLATFORMS
names the GPU (``cuda`` or ``gpu``) they run on the card instead, and the
tests marked ``gpu`` -- the compiled sweep kernel -- run too; elsewhere
those skip. Both settings must be made before JAX initialises a backend.
"""
import os

_ON_GPU = any(p in ("cuda", "gpu")
              for p in os.environ.get("JAX_PLATFORMS", "").split(","))
if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _card_only(request):
    """Skip a ``gpu``-marked test unless JAX's default device is a GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_seq(rng, length):
    return rng.integers(0, 4, size=length, dtype=np.uint8) + np.uint8(ord("A"))


def random_dna(rng, length) -> bytes:
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bytes(alphabet[rng.integers(0, 4, size=length)])


def mutate(rng, seq: bytes, sub_rate=0.1, indel_rate=0.05) -> bytes:
    """Generate a realistically-related sequence for alignment tests."""
    alphabet = b"ACGT"
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue  # deletion
        if r < indel_rate:
            out.append(alphabet[rng.integers(0, 4)])  # insertion
        if rng.random() < sub_rate:
            out.append(alphabet[rng.integers(0, 4)])
        else:
            out.append(c)
    if not out:
        out.append(alphabet[0])
    return bytes(out)
