"""Checkpoint / resume for long scenario sweeps (counterpart of
`mpc_collisionavoidance_tpu/utils/checkpointing.py`).

The reference has no on-disk checkpointing — the SQP-RTI warm start *is*
the checkpoint, held in acados process memory, plus a couple of carried
doubles (past_psied / past_Tport, reference
src/nmpc_guidance_ca1.cpp:593).  The port's equivalents are explicit
trees of NamedTuples of tensors (`SolverState`, `LaneState`,
`GuidanceState`, the fleet's carry), so a checkpoint is their leaves in
one `torch.save` file, and a template of the same tree shape rebuilds
the structure: a million-scenario sweep can stop and resume
mid-campaign with warm starts intact.
"""

import os
from typing import Any, List

import torch


def _leaves(tree) -> List[Any]:
    """The tree's leaves in order: NamedTuples, tuples and lists by
    position; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves` (an
    iterator)."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def save_state(path: str, state: Any) -> str:
    """Save any tree of tensors (solver/mission/sim state) to the file
    `path`; returns its absolute path.  The leaves are stored as CPU
    tensors under "leaf_<i>"; `restore_state` rebuilds the structure from
    a template."""
    path = os.path.abspath(path)
    leaves = [torch.as_tensor(leaf).detach().cpu().clone()
              for leaf in _leaves(state)]
    torch.save({f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}, path)
    return path


def restore_state(path: str, like: Any) -> Any:
    """Restore a tree saved with `save_state`, shaped like `like` (the
    template supplies the tree structure; each leaf takes the template
    leaf's device and dtype)."""
    path = os.path.abspath(path)
    restored = torch.load(path, map_location="cpu", weights_only=True)
    tmpl = _leaves(like)
    if len(restored) != len(tmpl):
        raise ValueError(
            f"checkpoint at {path} has {len(restored)} leaves but the "
            f"template has {len(tmpl)} — wrong template?")
    leaves = []
    for i, t in enumerate(tmpl):
        leaf = restored[f"leaf_{i}"]
        t_shape = getattr(t, "shape", None)
        if t_shape is not None and tuple(leaf.shape) != tuple(t_shape):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(leaf.shape)} but the "
                f"template expects {tuple(t_shape)} — wrong template?")
        if isinstance(t, torch.Tensor):
            leaf = leaf.to(device=t.device, dtype=t.dtype)
        leaves.append(leaf)
    return _rebuild(like, iter(leaves))
