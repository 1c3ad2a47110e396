"""PyTorch port vs the JAX package: the ContextNet modules, on the CPU in fp32.

``IdentityProjection`` (models/layers.py), ``SqueezeAndExcitationModule``,
``DepthwiseSeparableConv1d``, ``ContextNetBlock`` and
``ContextNetSubsampling`` (models/modules.py), each against the JAX module of
its name from the same numpy-seeded input and variables (kernels drawn with
numpy, norm scales, biases and BatchNorm statistics moved off their init),
carried by ``utils/weights.module_from_jax`` and loaded strictly: the
output (and the subsampling's lengths) within TOL of JAX's, relative to
max(|y|, 1), in eval mode (the running statistics) and in train mode (the
batch's statistics), where the running statistics the step leaves behind
are JAX's updated ``batch_stats`` within TOL too. The JAX package builds
none of them into a model, and the port registers them nowhere either.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_variants import jit_init, perturbed, rand

from efficientconformer_tpu.models import layers as JL
from efficientconformer_tpu.models import modules as JM
from efficientconformer_torch.models import layers as PL
from efficientconformer_torch.models import modules as PM
from efficientconformer_torch.utils.weights import module_from_jax

TOL = 1e-5
B, T, C = 2, 23, 16

# name: (JAX module, port module, input features, whether it takes the train flag)
CASES = {
    "identity-projection": (lambda: JL.IdentityProjection(features=28),
                            lambda: PL.IdentityProjection(C, 28), False),
    "squeeze-excitation": (lambda: JM.SqueezeAndExcitationModule(reduction_ratio=4,
                                                                 inner_act="swish"),
                           lambda: PM.SqueezeAndExcitationModule(C, 4, "swish"), False),
    "separable-conv-stride2": (lambda: JM.DepthwiseSeparableConv1d(features=24, kernel_size=5,
                                                                  stride=2),
                               lambda: PM.DepthwiseSeparableConv1d(C, 24, 5, stride=2), True),
    "separable-conv-causal": (lambda: JM.DepthwiseSeparableConv1d(features=24, kernel_size=5,
                                                                 causal=True),
                              lambda: PM.DepthwiseSeparableConv1d(C, 24, 5, causal=True), True),
    "block-se-residual-stride2": (
        lambda: JM.ContextNetBlock(num_layers=3, features=24, kernel_size=5, stride=2,
                                   se_ratio=4),
        lambda: PM.ContextNetBlock(C, 3, 24, 5, stride=2, se_ratio=4), True),
    "block-plain-causal": (
        lambda: JM.ContextNetBlock(num_layers=1, features=24, kernel_size=3, causal=True,
                                   se_ratio=None, residual=False),
        lambda: PM.ContextNetBlock(C, 1, 24, 3, causal=True, se_ratio=None, residual=False),
        True),
    "subsampling": (lambda: JM.ContextNetSubsampling(dim_model=24, kernel_size=5),
                    lambda: PM.ContextNetSubsampling(C, 24, 5), "lengths"),
    "subsampling-causal": (lambda: JM.ContextNetSubsampling(dim_model=24, kernel_size=5,
                                                            causal=True),
                           lambda: PM.ContextNetSubsampling(C, 24, 5, causal=True), "lengths"),
}


def rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_contextnet_module_matches_jax(name, train):
    """The port's module against the JAX module: output within TOL, the
    subsampling's lengths equal, and in train mode the running statistics
    left behind within TOL of JAX's updated batch_stats."""
    make_jax, make_port, kind = CASES[name]
    seed = list(CASES).index(name)
    x = rand(B, T, C, seed=seed)
    x_len = np.array([T, T - 6], np.int32)
    jmod = make_jax()
    args = (x, x_len) if kind == "lengths" else (x,)
    flags = {"train": False} if kind else {}
    variables = perturbed(jit_init(jmod, seed, *args, **flags), seed + 1)
    port = make_port()
    port.load_state_dict(module_from_jax(variables), strict=True)
    port.train(train)
    run = {"train": True} if kind and train else flags
    mutable = ["batch_stats"] if "batch_stats" in variables and train else False
    out = jmod.apply(variables, *map(jnp.asarray, args), **run, mutable=mutable)
    want, updated = out if mutable else (out, None)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    if kind == "lengths":
        (want, want_len), (got, got_len) = want, got
        assert got_len.tolist() == np.asarray(want_len).tolist()
    assert got.shape == np.shape(want)
    assert rel(got.numpy(), want) <= TOL
    if updated is not None:
        stats = module_from_jax({"params": variables["params"], **updated})
        state = port.state_dict()
        running = [k for k in stats if "running" in k]
        assert running
        for k in running:
            assert rel(state[k].numpy(), stats[k].numpy()) <= TOL, k
