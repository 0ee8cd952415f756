"""Stream-state checkpoint/resume.

The reference has **no** checkpointing: all stream state (FIR tails,
oscillator phase, demod history) is implicit in GPU buffers and C++ members
(SURVEY.md section 5).  Here the entire stream state is one explicit pytree,
so checkpointing is a flatten + np.savez — a capability this build adds.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp


def save_state(path: str, state: Any) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        str(treedef).encode("utf-8"), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_state(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like`` (a freshly
    init_state()'d pytree — structure is validated, shapes must match)."""
    with np.load(path) as data:
        leaves_like, treedef = jax.tree_util.tree_flatten(like)
        saved_def = bytes(data["__treedef__"]).decode("utf-8")
        if saved_def != str(treedef):
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  saved: {saved_def}\n  expected: {treedef}"
            )
        leaves = []
        for i, proto in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(np.shape(proto)):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != {np.shape(proto)}"
                )
            leaves.append(jnp.asarray(arr))
        return jax.tree_util.tree_unflatten(treedef, leaves)
