"""Platform rules shared by every intersector dispatch site.

One definition of where the walk kernel runs — the AUTO choice in
accel/traverse.py and the ring's in-shard query in dist/bigscene.py must
agree.  The kernel is compiled for the GPU (Pallas through Triton); on any
other backend it runs only when a caller asks for the Pallas interpreter
explicitly.  Nothing here falls back silently.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def check_kernel_platform(interpret: bool) -> None:
    """Raise unless the walk kernel can run: compiled on a GPU, or in the
    Pallas interpreter when ``interpret`` is set."""
    if not interpret and not on_gpu():
        raise ValueError(
            f"Intersector.PALLAS compiles for the GPU only (JAX backend is "
            f"{jax.default_backend()!r}); use Intersector.AUTO or TILED, or "
            f"pass interpret=True to run the Pallas interpreter")


def describe_devices() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    ``XLA_FLAGS`` in effect — printed beside every measured number."""
    import os

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "xla_flags": os.environ.get("XLA_FLAGS", "")}


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, as
    one line (the card's power limit bounds its clocks under load)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
