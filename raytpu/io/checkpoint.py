"""Optimization-state checkpointing (``np.savez`` of the flattened pytree).

The reference's only "checkpoints" are per-frame PNGs a crashed animation can
be re-stitched from (Game1.cs:156-161, :192-210, SURVEY.md §5).  Inverse-
rendering runs (BASELINE config 4) get real checkpoint/resume: params +
optimizer state saved every N steps, restored by diff/fit.py on restart.

One file per step, ``step_00000012.npz``: the pytree's leaves as
``leaf_0 .. leaf_{n-1}`` plus its tree structure as text, checked against
the caller's template on restore.  Files are written under a temporary name
and renamed, so a crash mid-save never leaves a torn latest checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


class FitCheckpointer:
    """Step-numbered pytree checkpoints under one directory; the newest
    ``keep`` are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self):
        found = (_NAME.match(n) for n in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}.npz")

    def save(self, step: int, state: Any) -> None:
        leaves, treedef = jax.tree.flatten(state)
        arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
        tmp = os.path.join(self._dir, f".step_{step:08d}.tmp.npz")
        np.savez(tmp, treedef=np.asarray(str(treedef)), **arrays)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self._keep]:
            os.remove(self._path(old))

    def restore_latest(self, template: Any) -> Optional[Tuple[int, Any]]:
        steps = self._steps()
        if not steps:
            return None
        leaves, treedef = jax.tree.flatten(template)
        with np.load(self._path(steps[-1])) as z:
            if str(z["treedef"]) != str(treedef):
                raise ValueError(
                    f"checkpoint step {steps[-1]} in {self._dir} has another "
                    f"tree structure than the template")
            loaded = [z[f"leaf_{i}"] for i in range(len(leaves))]
        for want, got in zip(leaves, loaded):
            if np.shape(want) != got.shape:
                raise ValueError(
                    f"checkpoint leaf shape {got.shape} != template "
                    f"{np.shape(want)}")
        restored = [jnp.asarray(g, dtype=jnp.asarray(w).dtype)
                    for w, g in zip(leaves, loaded)]
        return steps[-1], jax.tree.unflatten(treedef, restored)
