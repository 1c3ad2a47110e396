"""EfficientConformer CTC Large at 4 heads (heads 270 / 128 / 180, one
block a stage) in bf16, the port against the JAX package on the CPU.

The card runs this encoder's attention on the wide bf16 route (a padded
head past 144: chip_smoke.py's [wider-slice]); on the CPU the port's
rel-pos attention runs its plain version on the same bf16 inputs (fp32
inside, O rounded to bf16) and the JAX modules their XLA route in bf16, as
the JAX package's own tests run them off the TPU. Both compute in bf16
after the fp32 frontend (``compute_dtype``), so they round at different
places: the logits are held to each other within BF16_LOGITS_TOL of the
largest logit. fp32 parity at these widths is
test_torch_port_wide_fp32.py's.
"""

import numpy as np
import jax
import torch

from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_torch.models.model_ctc import ModelCTC
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.utils import weights as W
from test_torch_port_variants import jit_init, perturbed
from test_torch_port_wide_fp32 import VOCAB, wide_encoder

# bf16 keeps 8 mantissa bits (a step of 2^-8 relative); the two frameworks
# round activations, weights and the attention's inner products at other
# points through three blocks. Measured on this input: 8.4e-3 and 1.05e-2
# of the largest logit (1.86), about 2.5 bf16 steps at that magnitude.
BF16_LOGITS_TOL = 3e-2


def test_wide_head_encoder_matches_jax_in_bf16(monkeypatch):
    """Eval-mode logits and lengths of the 4-head Large encoder in bf16,
    every attention layer through the fused rel-pos wrapper (its plain
    version on the CPU, counted), against JAX's bf16 forward."""
    calls = []
    ref = RA.reference_relpos_attention

    def counted(*args):
        calls.append(args[0].dtype)
        return ref(*args)

    monkeypatch.setattr(RA, "reference_relpos_attention", counted)
    enc = dict(wide_encoder("EfficientConformerCTCLarge_heads4"), compute_dtype="bfloat16")
    jax_model = JaxModelCTC(encoder_params=enc, vocab_size=VOCAB)
    rng = np.random.default_rng(18)
    n = np.array([9600, 7200])
    x = (rng.standard_normal((2, n.max())) * 0.1).astype(np.float32)
    x[1, n[1]:] = 0.0
    x_len = n.astype(np.int32)
    variables = perturbed(jit_init(jax_model, 5, x, x_len), 6)
    port = ModelCTC(enc, VOCAB)
    port.load_state_dict(W.from_jax(variables), strict=True)

    want, want_len, _ = jax.jit(lambda v: jax_model.apply(v, x, x_len, False))(variables)
    with torch.no_grad():
        got, got_len = port.eval()(torch.from_numpy(x), torch.from_numpy(x_len))
    assert got.dtype == torch.bfloat16
    assert calls == [torch.bfloat16] * enc["num_blocks"]
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    want = np.asarray(want).astype(np.float32)
    scale = max(np.abs(want).max(), 1.0)
    for i, t in enumerate(got_len.tolist()):
        err = np.abs(got[i, :t].float().numpy() - want[i, :t]).max() / scale
        assert err <= BF16_LOGITS_TOL, (i, err)
