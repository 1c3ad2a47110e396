"""Replaying the beams' fixed-shape steps as CUDA graphs.

The beams' steps are plain PyTorch, as the JAX package's are plain XLA, but
eager PyTorch issues each operation as a launch from the host: a CTC frame
is ~150 of them and a Transducer pop's LM-Transformer step ~400, so the
host sets the pace. Their shapes are fixed for a whole search, so on the
card ``Graphed`` captures one call and replays it: the same operations, one
launch. On the CPU the steps run as they are.
"""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, tuples and lists of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


class Graphed:
    """``fn(*args)`` on fixed shapes as one CUDA graph: the arguments (trees
    of tensors) are copied into the graph's own, and the result is the
    graph's, valid until the next call."""

    def __init__(self, fn, *args):
        self.args = tree_map(torch.clone, args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.args)        # warm-up: lazy initialisation, cached tables
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.args)

    def __call__(self, *args):
        tree_map(lambda dst, src: dst.copy_(src), self.args, args)
        self.graph.replay()
        return self.out


def on_card(fn, *args):
    """``fn`` as a Graphed replay when its arguments lie on a CUDA device,
    else ``fn`` itself; ``args`` are example arguments of the right shapes."""
    return Graphed(fn, *args) if leaves(args)[0].is_cuda else fn
