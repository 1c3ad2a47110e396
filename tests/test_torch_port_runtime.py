"""PyTorch port vs the JAX package: the runtime, on the CPU.

``bn_refresh``, with dropout and SpecAugment off, over the same batches
(<= 1e-6 relative to the float64 statistics of the inputs, and within the
JAX package's own rounding of its statistics to the JAX package's), and
``evaluate`` (the same predictions, truths and WER, an eval loss <= 1e-5
relative) for a CTC and a Transducer model with the JAX package's weights
(``from_jax``), on tests/test_e2e.py's mini-LibriSpeech and tiny models.
The CLI over the same runtime is tests/test_torch_port_cli.py's.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from test_e2e import SENTENCES
from test_torch_port_checkpoint import tiny_config
from test_torch_port_data import make_flac_dataset

from efficientconformer_tpu import runtime as jax_runtime
from efficientconformer_tpu.config import from_dict
from efficientconformer_tpu.data import datasets as jax_datasets
from efficientconformer_tpu.data.tokenizer import BpeTokenizer as JaxBpeTokenizer
from efficientconformer_tpu.models import factory as jax_factory
from efficientconformer_tpu.runtime import example_microbatch
from efficientconformer_tpu.training.trainer import Trainer as JaxTrainer
from efficientconformer_torch import runtime
from efficientconformer_torch.data import datasets, preparation
from efficientconformer_torch.data.tokenizer import BpeTokenizer
from efficientconformer_torch.models.layers import _BatchNorm
from efficientconformer_torch.training.trainer import Trainer
from efficientconformer_torch.utils.weights import from_jax

RTOL = 1e-5
STATS_RTOL = 1e-6
# The JAX package's refreshed statistics lie up to 1.3e-5 (relative) from
# the float64 statistics of its own BatchNorm inputs (flax's float32
# reductions and the momentum recovery), while those inputs agree with the
# port's to 6e-8: measured on this test's data, first BatchNorm.
JAX_STATS_RTOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models here: the test workers share
    the machine's cores, and contended threads slow small ops many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prepare(root, cfg):
    """The mini-LibriSpeech, with a second training split (the first's
    utterances again: 16 in all, two refresh batches of 8), prepared by
    the port."""
    make_flac_dataset(root)
    shutil.copytree(os.path.join(root, "train-clean-100"), os.path.join(root, "train-other-500"))
    tp, kp = cfg["training_params"], cfg["tokenizer_params"]
    preparation.prepare_dataset(tp, kp, preparation.create_tokenizer(tp, kp))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(tmp dir, CTC config, Transducer config) over one prepared dataset."""
    tmp = tmp_path_factory.mktemp("runtime")
    root = str(tmp / "LibriSpeech")
    cfg = tiny_config(tmp, root)
    prepare(root, cfg)
    return tmp, cfg, tiny_config(tmp, root, "Transducer")


def both(cfg, seed=0):
    """The JAX trainer and a state of ``cfg``'s model, and a port trainer
    holding the same weights."""
    jcfg = from_dict(cfg)
    jt = JaxTrainer(jcfg, seed=seed)
    state = jt.init_state(example_microbatch(jcfg))
    port = Trainer(cfg, device="cpu")
    port.model.load_state_dict(from_jax({"params": jax.tree.map(np.asarray, state.params),
                                         "batch_stats": jax.tree.map(np.asarray,
                                                                     state.batch_stats)}))
    return jt, state, port


def datasets_of(cfg, split, **kw):
    tp, kp = cfg["training_params"], cfg["tokenizer_params"]
    args = (tp["training_dataset_path"], split)
    kw = dict(vocab_type=kp["vocab_type"], vocab_size=kp["vocab_size"], **kw)
    return datasets.LibriSpeechDataset(*args, **kw), jax_datasets.LibriSpeechDataset(*args, **kw)


def test_bn_refresh_matches_jax(setup, monkeypatch):
    """Two refresh batches of 8. The port's statistics are held to the
    float64 statistics of the inputs its BatchNorms saw (<= 1e-6, the
    cumulative average of the two batches), and to the JAX package's
    (<= JAX_STATS_RTOL). The JAX package's training-mode passes run
    compiled (they run op by op in its bn_refresh, ~40 s here)."""
    _, cfg, _ = setup
    jt, state, port = both(cfg)
    ds, jds = datasets_of(cfg, "train")
    assert len(ds) == 16
    apply = jax_factory.apply_model
    compiled = jax.jit(lambda variables, batch, rngs: apply(jt.model, variables, batch, True,
                                                             rngs=rngs))
    monkeypatch.setattr(jax_factory, "apply_model",
                        lambda model, variables, batch, train, rngs=None:
                        compiled(variables, batch, rngs))
    want = jax_runtime.bn_refresh(jt, state, jds, steps=5)
    norms = {n: m for n, m in port.model.named_modules() if isinstance(m, _BatchNorm)}
    seen = {n: [] for n in norms}
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: seen[n].append(i[0].double()))
             for n, m in norms.items()]
    try:
        assert runtime.bn_refresh(port, ds, steps=5) == 2
    finally:
        for h in hooks:
            h.remove()
    assert not port.model.training
    want_sd = from_jax({"params": jax.tree.map(np.asarray, want.params),
                        "batch_stats": jax.tree.map(np.asarray, want.batch_stats)})
    before = from_jax({"params": state.params, "batch_stats": state.batch_stats})
    sd = port.model.state_dict()
    assert len(norms) == 4
    for n, xs in seen.items():
        assert len(xs) == 2, n
        dims = [0] + list(range(2, xs[0].dim()))
        exact = {"running_mean": sum(x.mean(dim=dims) for x in xs) / 2,
                 "running_var": sum(x.var(dim=dims, correction=0) for x in xs) / 2}
        for stat, value in exact.items():
            k = f"{n}.{stat}"
            scale = value.abs().max().item()
            assert (sd[k].double() - value).abs().max().item() <= STATS_RTOL * scale, k
            assert (sd[k] - want_sd[k]).abs().max().item() <= JAX_STATS_RTOL * scale, k
            assert not torch.equal(sd[k], before[k]), k


@pytest.mark.parametrize("model_type", ["CTC", "Transducer"])
def test_evaluate_matches_jax(setup, model_type):
    """dev-clean's 4 utterances in batches of 3: the second batch repeats
    its one utterance to fill the microbatch, and is counted once."""
    _, ctc_cfg, rnnt_cfg = setup
    cfg = ctc_cfg if model_type == "CTC" else rnnt_cfg
    jt, state, port = both(cfg, seed=4)
    ds, jds = datasets_of(cfg, "dev-clean")
    path = cfg["tokenizer_params"]["tokenizer_path"]
    got = runtime.evaluate(port, ds, BpeTokenizer.load(path), batch_size=3, eval_loss=True)
    want = jax_runtime.evaluate(jt, state, jds, JaxBpeTokenizer.load(path), batch_size=3,
                                eval_loss=True)
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[1]) == 4 and got[1] == [s for s in SENTENCES[:4]]
    assert any(got[2]), "random weights decode to no token at all"
    assert got[0] == want[0]
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL)
