"""PyTorch port vs the JAX package: the continuous-batching server, on the
CPU in fp32.

Every schedule of tests/test_serving.py (staggered pushes and late submits
through a small pool, incremental emission, a zero-length stream, the
Transducer decoder, ``max_windows_per_tick``, and a whole generation of
slots finishing and being refilled in one tick) runs through the port's
``StreamingServer`` and the JAX package's on the same weights and audio.
Each stream's tokens must equal the JAX server's and the port's
single-stream session's for that stream alone. The causal encoder is
tests/test_streaming_runtime.py's CAUSAL_ENC; its weights reach the port
through utils/weights.from_jax.
"""

import numpy as np
import pytest
import torch

from efficientconformer_tpu import serving as JSV
from efficientconformer_torch import serving as SV
from efficientconformer_torch import streaming as S
from test_torch_port_streaming import CHUNK, LOOK, Pair
from tests.test_streaming_runtime import CAUSAL_ENC

MAX_TOKENS = 64


@pytest.fixture(scope="module")
def ctc():
    return Pair("ctc", CAUSAL_ENC, 0)


@pytest.fixture(scope="module")
def transducer():
    return Pair("transducer", CAUSAL_ENC, 2)


def streams(lengths, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def port_single_stream(pair, audio, decoder):
    """The port's oracle: a batch-1 session over the stream alone."""
    sess = S.StreamingEncoderSession(pair.port_encode, CAUSAL_ENC, batch_size=1,
                                     chunk_frames=CHUNK, lookahead_frames=LOOK, device="cpu")
    if decoder == "ctc":
        dec = S.StreamingCTC(sess)
        dec.push(audio[None, :])
        return [int(t) for t in dec.finish(np.array([audio.size]))[0]]
    dec = S.StreamingTransducer(pair.port, sess, max_tokens=MAX_TOKENS)
    dec.push(audio[None, :])
    toks, n = dec.finish(np.array([audio.size]))
    return toks[0, :int(n[0])].tolist()


def servers(pair, decoder, num_slots, **kw):
    """The JAX server and the port's, with the same geometry and decoder."""
    if decoder == "ctc":
        jdec, pdec = None, None
    else:
        jdec = JSV.TransducerGreedyDecoder(pair.jax, pair.variables, max_tokens=MAX_TOKENS)
        pdec = SV.TransducerGreedyDecoder(pair.port, max_tokens=MAX_TOKENS)
    geometry = dict(num_slots=num_slots, chunk_frames=CHUNK, lookahead_frames=LOOK, **kw)
    return (JSV.StreamingServer(pair.jax_encode, CAUSAL_ENC, decoder=jdec, **geometry),
            SV.StreamingServer(pair.port_encode, CAUSAL_ENC, decoder=pdec, device="cpu",
                               **geometry))


def staggered(srv, audios):
    """tests/test_serving.py:39: 5 streams through 2 slots, pushed in uneven
    bites, late arrivals submitted midway; forces slot reuse and queueing."""
    pos = [0] * len(audios)

    def feed(i, n):
        take = audios[i][pos[i]:pos[i] + n]
        if take.size:
            srv.push(f"s{i}", take)
        pos[i] += take.size

    srv.submit("s0"); srv.submit("s1")
    feed(0, 7000); feed(1, 9000)
    srv.end("s1")
    srv.tick()
    srv.submit("s2"); feed(2, 15000)
    feed(0, 17000); srv.end("s0")
    srv.tick()
    srv.submit("s3"); srv.submit("s4")
    feed(3, 16000); srv.end("s3")
    feed(2, 16000); srv.end("s2")
    srv.tick()
    feed(4, 24000); srv.end("s4")
    return srv.drain()


def incremental(srv, audios):
    """:91: one slot, the whole utterance staged before the first tick,
    which runs several windows and emits tokens; the stitched emissions
    are part of the result."""
    srv.submit("s0")
    srv.push("s0", audios[0])
    first = srv.tick()
    assert first.windows_run >= 1
    srv.end("s0")
    out = srv.drain()
    assert all(t in out["s0"] for t in first.emitted.get("s0", []))
    return out


def zero_length(srv, audios):
    """:113: a stream ended with no audio drains and gives the single
    stream's tokens."""
    srv.submit("s0")
    srv.end("s0")
    return srv.drain()


def transducer_churn(srv, audios):
    """:129: two streams fill the pool, a third queues behind them."""
    srv.submit("s0"); srv.push("s0", audios[0][:9000])
    srv.submit("s1"); srv.push("s1", audios[1]); srv.end("s1")
    srv.tick()
    srv.submit("s2"); srv.push("s2", audios[2]); srv.end("s2")
    srv.push("s0", audios[0][9000:]); srv.end("s0")
    return srv.drain()


def capped(srv, audios):
    """:188: with max_windows_per_tick 1 every tick runs at most one window
    step; deep backlogs carry to later ticks and the results are the
    uncapped ones."""
    for i, a in enumerate(audios):
        srv.submit(f"s{i}"); srv.push(f"s{i}", a); srv.end(f"s{i}")
    ticks = 0
    while srv.active_streams or srv.queued_streams:
        assert srv.tick().windows_run <= 1
        ticks += 1
        assert ticks < 200
    assert ticks >= 8
    return {f"s{i}": srv.result(f"s{i}") for i in range(len(audios))}


def generations(srv, audios):
    """:226: every stream staged up front, so each generation of 3 slots
    finishes in one tick and the next is admitted together."""
    for i, a in enumerate(audios):
        srv.submit(f"s{i}"); srv.push(f"s{i}", a); srv.end(f"s{i}")
    while srv.active_streams or srv.queued_streams:
        srv.tick()
    return {f"s{i}": srv.result(f"s{i}") for i in range(len(audios))}


SCHEDULES = {
    # name: (schedule, decoder, slots, stream lengths, server options)
    "staggered": (staggered, "ctc", 2, [24000, 9000, 31000, 16000, 24000], {}),
    "incremental": (incremental, "ctc", 1, [30000], {}),
    "zero-length": (zero_length, "ctc", 1, [0], {}),
    "transducer": (transducer_churn, "transducer", 2, [24000, 10000, 17000], {}),
    "capped": (capped, "ctc", 2, [60000, 45000, 90000], {"max_windows_per_tick": 1}),
    "generations": (generations, "ctc", 3,
                    [21000, 21000, 21000, 16000, 24000, 19000, 9000, 31000, 21000], {}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_server_matches_jax_and_single_stream(name, request):
    schedule, decoder, slots, lengths, kw = SCHEDULES[name]
    pair = request.getfixturevalue(decoder)
    audios = streams(lengths, seed=len(name))
    jax_srv, port_srv = servers(pair, decoder, slots, **kw)
    want = schedule(jax_srv, audios)
    got = schedule(port_srv, audios)
    oracle = {f"s{i}": port_single_stream(pair, a, decoder) for i, a in enumerate(audios)}
    assert set(got) == set(want) == set(oracle)
    for sid in oracle:
        assert got[sid] == list(map(int, want[sid])), sid
        assert got[sid] == oracle[sid], sid
    if name != "zero-length":
        assert sum(map(len, got.values())) > 0


def test_server_client_errors(ctc):
    srv = SV.StreamingServer(ctc.port_encode, CAUSAL_ENC, num_slots=1, device="cpu")
    srv.submit("a")
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit("a")
    with pytest.raises(KeyError):
        srv.push("b", np.zeros(10, np.float32))
    srv.end("a")
    with pytest.raises(ValueError, match="already ended"):
        srv.push("a", np.zeros(10, np.float32))
    assert srv.result("a") is None
    srv.drain()
    assert srv.result("a") is not None


def test_window_buffer_stays_on_the_server_device(ctc):
    """The rolling windows live in one (slots, window_samples) device
    buffer; a tick moves each row by its own shift."""
    srv = SV.StreamingServer(ctc.port_encode, CAUSAL_ENC, num_slots=2, chunk_frames=CHUNK,
                             lookahead_frames=LOOK, device="cpu")
    assert srv._buf.shape == (2, srv.window_samples) and srv._buf.device.type == "cpu"
    a = streams([40000], seed=1)[0]
    srv.submit("a"); srv.push("a", a)
    out = srv.tick()
    assert out.windows_run > 1
    # row 0 now holds the stream's last complete window, row 1 stays zero
    end = srv._slots[0].uploaded
    torch.testing.assert_close(srv._buf[0], torch.from_numpy(a[end - srv.window_samples:end]))
    assert float(srv._buf[1].abs().sum()) == 0.0
