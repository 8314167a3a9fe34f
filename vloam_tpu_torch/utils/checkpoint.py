"""Checkpoint / resume (port of ``vloam_tpu/utils/checkpoint.py``).

The whole pipeline state is one tree of NamedTuples whose leaves are
tensors and a few host values (the frame counters and the ``initialized``
flags), so a snapshot is one ``torch.save`` of the flattened leaves, moved
to the CPU, plus the frame index.  ``load_checkpoint`` takes a template
state (from ``init_vloam_state``) for the tree structure and the device to
restore onto.
"""

from __future__ import annotations

import os

import torch


def tree_leaves(tree) -> list:
    """Leaves of a tree of (named) tuples, depth first."""
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_unflatten(template, leaves):
    """The tree shaped like ``template`` holding ``leaves`` (an iterator)."""
    if isinstance(template, tuple):
        children = [tree_unflatten(child, leaves) for child in template]
        return type(template)(*children) if hasattr(template, "_fields") else tuple(children)
    return next(leaves)


def save_checkpoint(path: str, state, frame_index: int) -> None:
    """Snapshot a VloamState (or any tree of tuples) + frame counter to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    leaves = [x.detach().cpu() if isinstance(x, torch.Tensor) else x for x in tree_leaves(state)]
    tmp = path + ".tmp"
    torch.save({"leaves": leaves, "frame": int(frame_index)}, tmp)
    os.replace(tmp, path)  # a crash mid-save never leaves half a checkpoint


def load_checkpoint(path: str, template_state):
    """Restore (state, frame_index) onto the template's device;
    ``template_state`` supplies the tree structure, shapes and dtypes."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    want = tree_leaves(template_state)
    got = saved["leaves"]
    if len(got) != len(want):
        raise ValueError(f"checkpoint {path}: {len(got)} leaves, the state has {len(want)}")
    leaves = []
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, torch.Tensor):
            if not isinstance(g, torch.Tensor) or g.shape != w.shape or g.dtype != w.dtype:
                raise ValueError(
                    f"checkpoint {path}: leaf {i} is {getattr(g, 'shape', type(g))}/"
                    f"{getattr(g, 'dtype', '')}, the state wants {tuple(w.shape)}/{w.dtype}")
            leaves.append(g.to(w.device))
        else:
            leaves.append(type(w)(g))
    return tree_unflatten(template_state, iter(leaves)), int(saved["frame"])
