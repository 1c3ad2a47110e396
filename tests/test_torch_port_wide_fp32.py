"""The fp32 rel-pos route at the widths of the shipped Medium and Large
encoders, on the CPU.

The wrapper's route table (ops/rel_attention.py: ``refusal``,
``smem_bytes`` and ``fma_resident``) is computed in Python from the kernel
files' constants, so it is checked here without the compiled kernels: its
copies of the constants, and its sizes against the kernel files' own size
functions read as Python (``c_file``), then every shipped ASR config's
stage shapes taken by both routes in both directions, at 16 s and at an evaluation split's
33 s, and the shapes past the new limits refused with their ROADMAP item.
Then the port held to the JAX package in fp32 at those widths, on weights
carried by utils/weights.py: EfficientConformer CTC Medium's and Large's
three stage widths with one block a stage, Conformer CTC Large's 512 / 8
heads with one block. On the CPU the port's rel-pos attention runs its
plain version; the JAX modules run their XLA route, as the JAX package's
own tests run them off the TPU. The CUDA kernels are held to the plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py's
[wide-fp32-kernel] and [wide-fp32-slice]).
"""

import functools
import json
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientconformer_tpu.models.model_ctc import ModelCTC as JaxModelCTC
from efficientconformer_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from efficientconformer_torch.config import resolve_block_configs
from efficientconformer_torch.models.model_ctc import ModelCTC
from efficientconformer_torch.ops import rel_attention as RA
from efficientconformer_torch.ops.ctc_loss import ctc_loss
from efficientconformer_torch.utils import weights as W
from test_torch_port_variants import assert_grads_close, jit_init, perturbed

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "efficientconformer_torch" / "csrc"
ASR_CONFIGS = sorted(p.stem for p in (ROOT / "configs").glob("*.json")
                     if not p.stem.startswith("LM-"))
SECONDS = (16.0, 33.0)   # train_audio_max_length, and an evaluation split's longest
LOGITS_TOL = 1e-5        # fp32 logits, same arithmetic in another order
GRAD_TOL = 1e-4          # gradients, relative to max(max|g|, 1)
VOCAB = 32


# ------------------------------------------------------------- route table


# The kernel files' size helpers, read as Python: each constexpr constant and
# each function of int (or size_t) arguments whose body is `return`, `if (..)
# return` and `const` declarations, in C's own arithmetic (integer division,
# ?:, static_cast, sizeof of float and bf16), so that the wrapper's mirrors
# are held to the formulas the kernels are launched with, not only to their
# constants.
C_FUNCTION = re.compile(r"^(?:__host__ __device__ )?(?:constexpr )?(?:inline )?"
                        r"(?:int|size_t|bool) (\w+)\(((?:(?:int|size_t) \w+(?:, )?)*)\) "
                        r"\{(.*?)\}$", re.M | re.S)


def _outside_parens(s: str):
    depth = 0
    for i, ch in enumerate(s):
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch not in "()":
            yield i, ch


def _split(s: str, sep: str = ",") -> list[str]:
    cuts = [i for i, ch in _outside_parens(s) if ch == sep]
    return [s[a + 1:b] for a, b in zip([-1] + cuts, cuts + [len(s)])]


def _ternary(s: str) -> str:
    """C's right-associative a ? b : c, inside parentheses or not, as
    Python's (b if a else c)."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(" and depth == 0:
            parts.append(s[start:i])
            start = i + 1
        depth += (ch == "(") - (ch == ")")
        if ch == ")" and depth == 0:
            parts.append("(" + ", ".join(_ternary(a) for a in _split(s[start:i])) + ")")
            start = i + 1
    s = "".join(parts) + s[start:]
    marks = [(i, ch) for i, ch in _outside_parens(s) if ch in "?:"]
    nest = 0
    for i, ch in marks[1:]:
        if ch == "?":
            nest += 1
        elif nest:
            nest -= 1
        else:
            q = marks[0][0]
            return f"({_ternary(s[q + 1:i])} if {_ternary(s[:q])} else {_ternary(s[i + 1:])})"
    return s


def c_expr(expr: str) -> str:
    expr = re.sub(r"static_cast<[\w:]+>", "", expr)
    expr = expr.replace("sizeof(float)", "4").replace("sizeof(tc::bf16)", "2")
    expr = re.sub(r"(\w+)::(\w+)", r"\1_\2", expr).replace("/", "//")
    return _ternary(expr.replace("&&", " and ").replace("||", " or ")).strip()


def c_statement(stmt: str) -> list[str]:
    stmt = stmt.strip()
    if stmt.startswith("if ("):
        close = next(i for i in range(4, len(stmt))
                     if stmt[:i + 1].count("(") == stmt[:i + 1].count(")"))
        return [f"if {c_expr(stmt[3:close + 1])}: {c_statement(stmt[close + 1:])[0]}"]
    if stmt.startswith("return "):
        return [f"return {c_expr(stmt[7:])}"]
    decl = re.match(r"const (?:int|size_t) (.*)", stmt, re.S)
    assert decl, stmt
    return [f"{name.strip()} = {c_expr(value)}"
            for name, value in (d.split("=", 1) for d in _split(decl.group(1)))]


@functools.lru_cache(maxsize=None)
def c_file(name: str) -> tuple[dict, dict]:
    """The constants and size functions of csrc/<name> by their names in
    it, and what it exports: a header's under <namespace>_<name> (c_expr
    spells rfma::BQ so), with what its own headers export."""
    text = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
    inherited, own = {}, []
    for header in re.findall(r'^#include "(\w+\.cuh)"', text, re.M):
        inherited.update(c_file(header)[1])
    env = dict(inherited)
    for space, key in re.findall(r"^using (\w+)::(\w+);", text, re.M):
        if f"{space}_{key}" in env:          # not a type
            env[key] = env[f"{space}_{key}"]
    for key, expr in re.findall(r"^constexpr (?:int|size_t) (\w+) = ([^;]+);", text, re.M):
        env[key] = eval(c_expr(expr), env)
        own.append(key)
    for fn, args, body in C_FUNCTION.findall(text):
        names = ", ".join(a.split()[-1] for a in args.split(", ") if a)
        try:
            lines = [line for stmt in " ".join(body.split()).split(";")[:-1]
                     for line in c_statement(stmt)]
            exec(f"def {fn}({names}):\n" + "".join(f"    {line}\n" for line in lines), env)
        except (AssertionError, SyntaxError):   # code this reading does not cover
            continue
        own.append(fn)
    ns = re.search(r"^namespace (\w+) \{", text, re.M)
    exports = dict(inherited)
    if ns:
        exports.update({f"{ns.group(1)}_{k}": env[k] for k in own})
    return env, exports


def constants(name: str) -> dict:
    """The constexpr ints and sizes of csrc/<name>."""
    return {k: v for k, v in c_file(name)[0].items() if isinstance(v, int)}


@pytest.mark.parametrize("name,header,key", [
    ("FMA_MAX_DH", "relpos_fma.cuh", "MAX_DH"), ("FMA_BQ", "relpos_fma.cuh", "BQ"),
    ("FMA_BQ", "relpos_fma.cuh", "BK"), ("FMA_DC", "relpos_fma.cuh", "DC"),
    ("FMA_LDA", "relpos_fma.cuh", "LDA"), ("FMA_LDB", "relpos_fma.cuh", "LDB"),
    ("FMA_LDV", "relpos_fma.cuh", "LDV"), ("FMA_LDS", "relpos_fma.cuh", "LDS"),
    ("FMA_WCHUNK", "relpos_fma.cuh", "WCHUNK"), ("FMA_LDAS", "relpos_fma.cuh", "LDAS"),
    ("SMEM_LIMIT", "relpos_fma.cuh", "MAX_SMEM"), ("TC_BQ", "relpos_tc.cuh", "BQ"),
    ("TC_KC", "relpos_tc.cuh", "KC"), ("TC_LDC", "relpos_tc.cuh", "LDC"),
    ("TC_BK", "rel_attention_fwd.cu", "TC_BK"), ("TC_BK", "rel_attention_bwd.cu", "TC_BK"),
    ("TC_TQ", "rel_attention_bwd.cu", "TC_TQ"),
    ("FMA_RESIDENT_MAX_DH", "rel_attention_fwd.cu", "RESIDENT_MAX_DH"),
])
def test_wrapper_constants_match_the_kernels(name, header, key):
    """The wrapper's copies of the kernels' compile-time constants agree
    with csrc/: a stride or a limit that differs would size the route table
    for another kernel than the one that runs."""
    assert constants(header)[key] == getattr(RA, name)


@pytest.mark.parametrize("source,fn,table", [
    ("rel_attention_fwd.cu", "jmax_for", "FMA_COLUMNS"),
    ("rel_attention_bwd.cu", "jd_for", "FMA_KEY_COLUMNS"),
    ("rel_attention_fwd.cu", "tc_dmax", None),
])
def test_wrapper_column_tables_match_the_kernels(source, fn, table):
    """The output columns a thread owns, as the kernels pick them (a chain
    of `x <= w ? j :` ending in a default), against the wrapper's tables,
    whose last row is the default's and the widest width taken; and the
    bf16 route's widest padded head, tc_dmax's default, against
    TC_MAX_DHP."""
    body = re.search(rf"{fn}\(int \w+\) \{{\s*return ([^;]+);",
                     (CSRC / source).read_text())
    assert body, fn
    steps = tuple((int(w), int(j)) for w, j in re.findall(r"<= (\d+) \? (\d+)", body.group(1)))
    default = int(body.group(1).rsplit(":", 1)[1])
    if table is None:
        assert max(w for w, _ in steps) < default == RA.TC_MAX_DHP
        return
    table = getattr(RA, table)
    assert table[:-1] == steps and table[-1][1] == default
    assert all(16 * j >= w for w, j in table)
    assert RA.FMA_COLUMNS[-1][0] == RA.FMA_MAX_DH and RA.FMA_KEY_COLUMNS[-1][0] == 128


def stage_shapes(config: str, seconds: float):
    """(N, dh, D) of each distinct attention shape of the config's encoder
    at ``seconds`` of audio, as the encoder gives them (the query rows of
    a grouped stage are its groups)."""
    p = json.loads((ROOT / "configs" / f"{config}.json").read_text())["encoder_params"]
    hop = p["sample_rate"] * p["hop_length_ms"] // 1000
    t = round(seconds * 16000) // hop + 1
    for _ in range(p["subsampling_layers"]):
        t = (t - 1) // 2 + 1
    shapes = set()
    for blk in resolve_block_configs(p):
        g = blk.att_group_size
        shapes.add((-(-t // g), g * blk.dim_model // blk.num_heads, blk.dim_model))
        if blk.stride > 1:
            t = (t - 1) // blk.stride + 1
    return sorted(shapes)


@pytest.mark.parametrize("config", ASR_CONFIGS)
@pytest.mark.parametrize("seconds", SECONDS)
def test_every_shipped_stage_shape_is_taken(config, seconds):
    """Neither route refuses any stage shape of any shipped ASR config in
    either direction, and each fits the 227 KB a block may use: fp32 Medium
    and Large (dh 135, dh + D up to 810) included."""
    assert len(ASR_CONFIGS) == 12
    for _, dh, d in stage_shapes(config, seconds):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                assert RA.refusal(dtype, dh, d, backward) is None, (dtype, dh, d, backward)
            assert max(RA.smem_bytes(dtype, dh, d)) <= RA.SMEM_LIMIT
        assert_route_table_is_the_kernels(dh, d)


def test_fp32_shared_memory_fits_at_any_rel_width():
    """The fp32 backward and the streamed forward stream every product, so
    their shared memory depends on the head width only: at the widest head
    taken (256) the largest pass, the prep's, needs 119,040 bytes at any
    rel width. The forward's resident kernel holds [qu | A] whole and takes
    the widths where that fits (up to D 712 at dh 64), the streamed kernel
    the rest."""
    for d in (24, 720, 1024, 8192):
        assert RA.smem_bytes(torch.float32, RA.FMA_MAX_DH, d) == (119040, 119040)
        assert RA.refusal(torch.float32, RA.FMA_MAX_DH, d, backward=True) is None
        assert RA.refusal(torch.float32, 64, d) is None
    assert RA.smem_bytes(torch.float32, 90, 120)[1] == RA.smem_bytes(torch.float32, 90, 720)[1]
    assert RA.fma_resident(64, 712) and not RA.fma_resident(64, 720)
    assert RA.smem_bytes(torch.float32, 64, 712)[0] == RA.SMEM_LIMIT
    assert not RA.fma_resident(135, 24) and RA.fma_resident(128, 24)


SIZE_SHAPES = ((12, 24), (42, 168), (60, 240), (64, 512), (64, 712), (64, 720), (90, 360),
               (90, 720), (128, 256), (135, 180), (135, 360), (200, 64), (256, 1024),
               (64, 4000))


@functools.lru_cache(maxsize=None)
def kernel_size_functions() -> tuple:
    fwd, bwd = c_file("rel_attention_fwd.cu")[0], c_file("rel_attention_bwd.cu")[0]
    return (fwd["ecf_relpos_attention_fwd_smem"], bwd["ecf_relpos_attention_bwd_smem"],
            fwd["ecf_relpos_attention_fwd_resident"])


def assert_route_table_is_the_kernels(dh: int, d: int):
    fwd_smem, bwd_smem, resident = kernel_size_functions()
    for dtype, code in RA._DTYPE_CODE.items():
        assert (fwd_smem(code, dh, d), bwd_smem(code, dh, d)) == RA.smem_bytes(dtype, dh, d), \
            (dtype, dh, d)
    assert bool(resident(dh, d)) == RA.fma_resident(dh, d), (dh, d)


@pytest.mark.parametrize("dh,d", SIZE_SHAPES)
def test_route_table_is_the_kernels_own(dh, d):
    """The wrapper's shared memory of each route and direction, and the
    fp32 forward's choice of kernel, equal what the kernel files' own size
    functions (ecf_relpos_attention_{fwd,bwd}_smem,
    ecf_relpos_attention_fwd_resident) give, read from csrc/: the formulas
    the kernels are launched with, not only their constants."""
    assert_route_table_is_the_kernels(dh, d)


@pytest.mark.parametrize("dtype,dh,d,backward,match", [
    (torch.float32, 257, 64, False, r"head width 257 > 256 \(ROADMAP \[27\]\)"),
    (torch.float32, 272, 544, True, r"head width 272 > 256 \(ROADMAP \[27\]\)"),
    (torch.bfloat16, 150, 64, False, r"padded head width 160 > 144 \(ROADMAP \[27\]\)"),
    (torch.bfloat16, 64, 4000, True, r"shared memory in the backward, more than 232448 "
                                     r"\(ROADMAP \[27\]\)"),
])
def test_past_the_limits_is_refused_naming_its_roadmap_item(dtype, dh, d, backward, match):
    why = RA.refusal(dtype, dh, d, backward)
    assert why is not None and re.search(match, why), why
    item = RA.ROADMAP_ITEM.removeprefix("ROADMAP ")     # an item of ROADMAP.md's queues
    assert f"- **{item} " in (ROOT / "ROADMAP.md").read_text()


# ---------------------------------------------------- the port held to JAX


def encoder_params(config: str, **cut) -> dict:
    """The config's encoder at its published widths, heads, groups and
    kernels, cut as ``cut`` says; dropout 0 and SpecAugment off, since
    random masks cannot match across frameworks."""
    p = json.loads((ROOT / "configs" / f"{config}.json").read_text())["encoder_params"]
    return dict(p, Pdrop=0.0, spec_augment=False, **cut)


WIDE = {
    # one block a stage: the stride and the expansion after blocks 0 and 1
    "EfficientConformerCTCMedium": dict(num_blocks=3, strided_blocks=[0, 1],
                                        expand_blocks=[0, 1]),
    "EfficientConformerCTCLarge": dict(num_blocks=3, strided_blocks=[0, 1],
                                       expand_blocks=[0, 1]),
    "ConformerCTCLarge": dict(num_blocks=1),
}


@pytest.mark.parametrize("config", list(WIDE))
def test_wide_encoder_matches_jax_in_fp32(config, monkeypatch):
    """Logits and lengths in eval mode (BatchNorm on perturbed running
    statistics), then one training step's gradients: the mean CTC loss in
    train mode (BatchNorm on the batch's statistics), against jax.grad of
    the same loss. One jitted JAX function a config gives both. Every
    attention layer goes through the fused rel-pos wrapper, both ways (its
    plain versions, on the CPU, counted)."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("reference_relpos_attention", "fwd"),
                      ("reference_relpos_attention_bwd", "bwd")):
        def counted(*args, _fn=getattr(RA, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(RA, name, counted)
    enc = encoder_params(config, **WIDE[config])
    widths = {b.dim_model for b in resolve_block_configs(enc)}
    heads = {b.att_group_size * b.dim_model // b.num_heads for b in resolve_block_configs(enc)}
    assert widths == {"EfficientConformerCTCMedium": {180, 256, 360},
                      "EfficientConformerCTCLarge": {360, 512, 720},
                      "ConformerCTCLarge": {512}}[config]
    assert max(heads) > 128 or max(h + d for h, d in zip(sorted(heads), sorted(widths))) > 416
    jax_model = JaxModelCTC(encoder_params=enc, vocab_size=VOCAB)
    rng = np.random.default_rng(len(config))
    n = np.array([9600, 7200])
    x = (rng.standard_normal((2, n.max())) * 0.1).astype(np.float32)
    x[1, n[1]:] = 0.0
    x_len = n.astype(np.int32)
    labels = rng.integers(1, VOCAB, (2, 5)).astype(np.int32)
    y_len = np.array([5, 3], np.int32)
    variables = perturbed(jit_init(jax_model, 3, x, x_len), 4)
    port = ModelCTC(enc, VOCAB)
    port.load_state_dict(W.from_jax(variables), strict=True)

    @jax.jit
    def both(params):
        logits, f_len, _ = jax_model.apply({**variables, "params": params}, x, x_len, False)

        def loss(params):
            (out, lens, _), _ = jax_model.apply({**variables, "params": params}, x, x_len, True,
                                                mutable=["batch_stats"])
            return jnp.mean(jax_ctc_loss(jax.nn.log_softmax(out, -1), labels, lens, y_len))

        return logits, f_len, jax.value_and_grad(loss)(params)

    want, want_len, (want_loss, grads) = both(variables["params"])
    with torch.no_grad():
        got, got_len = port.eval()(torch.from_numpy(x), torch.from_numpy(x_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, t in enumerate(got_len.tolist()):
        np.testing.assert_allclose(got[i, :t].numpy(), np.asarray(want)[i, :t], rtol=0,
                                   atol=LOGITS_TOL)

    port.train()
    logits, f_len = port(torch.from_numpy(x), torch.from_numpy(x_len), torch.Generator())
    loss = ctc_loss(torch.log_softmax(logits, -1), torch.from_numpy(labels).long(), f_len,
                    torch.from_numpy(y_len).long()).mean()
    loss.backward()
    blocks = enc["num_blocks"]
    assert calls == {"fwd": 2 * blocks, "bwd": blocks}
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want_grads = W.params_from_jax(grads)
    # a parameter the port's path does not reach (the pos bias, which cancels
    # in the factorized softmax) has no gradient: JAX's is zero
    assert_grads_close({k: p.grad if p.grad is not None else torch.zeros_like(p)
                        for k, p in port.named_parameters()},
                       {k: want_grads[k] for k, _ in port.named_parameters()}, tol=GRAD_TOL)
