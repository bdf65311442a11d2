"""The decode loops as captured CUDA graphs (``inference.decoding.
DecodeGraphs``), their cache logic on the CPU.

A CUDA graph cannot be captured here, so ``StubGraphs`` stands in for the
card's capture and replay and keeps everything else of ``DecodeGraphs``:
the shape key, the entry's buffers, the prologue that loads and resets
them, the warm-up, the least-recently-used bound and the launch counts
recorded at capture and added at each replay.  A stub capture runs the
step body's Python (so the kernel wrappers' launches are recorded) and
puts the state back, as a capture runs nothing; a stub replay runs the
body with the wrappers' counting suppressed, as a replay runs no Python.
``decoding._graphs_for`` is patched to hand out the stub on CPU tensors.

Bars: every output equal to a fresh eager decode (``*_eager``, the same
step body step by step) bit for bit, ``steps`` equal; launch counts equal
to the eager loop's; ``uniforms`` called at the same steps in the same
order and a ``torch.Generator`` left in the same state.  The card's own
capture is held to the eager loop by tests/test_torch_cuda.py and
chip_smoke.py's phase "graphs".  Tiny configs, no JAX.
"""

import os
import subprocess
import sys

import pytest
import torch

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.inference import decoding
from spmm_tpu_torch.models.rxn import Rxn
from spmm_tpu_torch.ops import _build, decode_attention

DC = BertArchConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, fusion_layer=1, encoder_width=32)
EC = BertArchConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, fusion_layer=1,
                    add_cross_attention=False)
# weights 10x the init's and [SEP] raised: decodes of other inputs stop
# at other steps (2 to 13 at max_steps 12)
WEIGHT_SCALE, SEP_BIAS = 10.0, 3.0
M, LE = 4, 6


class StubGraph:
    def __init__(self, state, pos):
        saved = [t.clone() for t in state.buffers()]
        state.step(pos)                      # launches recorded, not counted
        for t, s in zip(state.buffers(), saved):
            t.copy_(s)                       # ... and nothing ran
        self.state, self.pos = state, pos

    def replay(self):
        with _build.captured_launches():     # no Python runs in a replay
            self.state.step(self.pos)


class StubGraphs(decoding.DecodeGraphs):
    def __init__(self):
        super().__init__()
        self.warm_ups = 0

    def _warm_up(self, entry):
        self.warm_ups += 1
        for pos in (0, 1):
            entry.state.step(pos, attention="plain")

    def _capture(self, entry, pos):
        return StubGraph(entry.state, pos)


@pytest.fixture(scope="module")
def decoder():
    torch.set_num_threads(1)
    dec = Rxn.random_init(0, DC, EC, device="cpu").text_encoder.eval()
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 2:
                p.mul_(WEIGHT_SCALE)
        dec.cls.predictions.bias[3] += SEP_BIAS
    return dec


@pytest.fixture
def stub(monkeypatch):
    graphs = StubGraphs()
    monkeypatch.setattr(decoding, "_graphs_for", lambda model, dev: graphs)
    return graphs


def inputs(seed, m=M, le=LE):
    g = torch.Generator().manual_seed(seed)
    enc = torch.randn(m, le, DC.encoder_width, generator=g)
    mask = torch.ones(m, le, dtype=torch.int32)
    mask[1:, le - 2:] = 0
    return enc, mask


def beam(dec, x, eager=False, k=2, max_steps=12, stop_count=2, **kw):
    fn = (decoding.beam_search_batched_eager if eager
          else decoding.beam_search_batched)
    spec = decoding.BeamSpec(k=k, stop_count=stop_count, max_steps=max_steps,
                             stochastic="generator" in kw or "uniforms" in kw)
    return fn(dec, DC, *x, spec, **kw)


def greedy(dec, x, eager=False, max_steps=12, **kw):
    fn = decoding.greedy_decode_eager if eager else decoding.greedy_decode
    return fn(dec, DC, *x, max_steps=max_steps, **kw)


DECODES = {"beam": beam, "greedy": greedy}


def assert_same(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "steps":
            assert got[key] == value
        else:
            assert got[key].dtype == value.dtype, key
            assert torch.equal(got[key], value), key


def test_the_cpu_runs_the_eager_loop_and_the_card_the_graphs(decoder):
    assert decoding._graphs_for(decoder, torch.device("cpu")) is None
    assert (decoding._graphs_for(decoder, torch.device("cuda"))
            is decoding.graph_cache)


@pytest.mark.parametrize("kind", list(DECODES))
def test_calls_of_one_shape_each_equal_a_fresh_decode(decoder, stub, kind):
    """No KV cache, harvest buffer or step count is left from the last
    call: the second call of a shape, on other inputs, equals a fresh
    decode, whichever ran longer."""
    run = DECODES[kind]
    first, second = inputs(2), inputs(4)
    want = [run(decoder, x, eager=True) for x in (first, second)]
    assert want[0]["steps"] < want[1]["steps"]
    got = [run(decoder, x) for x in (first, second)]
    for g, w in zip(got, want):
        assert_same(g, w)
    stats = stub.stats()
    assert len(stats["shapes"]) == 1 and stub.warm_ups == 1
    assert stats["captured"] == max(w["steps"] for w in want)
    assert stats["shapes"][0]["graphs"] == stats["captured"]
    # a third call replays only
    assert_same(run(decoder, first), want[0])
    assert stub.stats()["captured"] == stats["captured"]


def test_another_shape_in_between_changes_nothing(decoder, stub):
    x1, x2 = inputs(1), inputs(2)
    other = inputs(3, m=3, le=5)
    want = beam(decoder, x2, eager=True)
    beam(decoder, x1)
    assert_same(greedy(decoder, other), greedy(decoder, other, eager=True))
    assert_same(beam(decoder, other, k=3, stop_count=3),
                beam(decoder, other, eager=True, k=3, stop_count=3))
    assert_same(beam(decoder, x2), want)
    assert len(stub.stats()["shapes"]) == 3


def test_the_bound_drops_the_least_recently_used_shape(decoder, stub):
    """MAX_SHAPES (4) shapes are kept; a fifth drops the one used least
    recently, which is captured anew when it comes back."""
    assert stub.MAX_SHAPES == 4
    xs = {m: inputs(1, m=m) for m in (2, 3, 4, 5, 6)}

    def kept():
        return [row["m"] for row in stub.stats()["shapes"]]

    for m in (2, 3, 4, 5, 2, 6):      # 2 used again after 3: 3 is dropped
        greedy(decoder, xs[m])
    assert kept() == [4, 5, 2, 6]
    captured = stub.stats()["captured"]
    assert_same(greedy(decoder, xs[3]), greedy(decoder, xs[3], eager=True))
    assert kept() == [5, 2, 6, 3]
    assert stub.stats()["captured"] > captured       # 3 captured anew


@pytest.mark.parametrize("kind", list(DECODES))
def test_replays_count_the_launches_the_eager_loop_counts(decoder, stub,
                                                         monkeypatch, kind):
    """Kernel 1's launches are recorded at capture and added at each
    replay: L a step, in the capturing call and in a replaying one; the
    warm-up (plain attention) and the capture count none."""
    wrapper = decode_attention.beam_decode_attention

    def counted(*args):
        _build.count_launch(wrapper)
        return decode_attention.beam_decode_attention_reference(*args)

    monkeypatch.setattr(decoding, "beam_decode_attention", counted)
    run = DECODES[kind]
    for x in (inputs(1), inputs(2), inputs(1)):
        before = wrapper.launches
        want = run(decoder, x, eager=True)
        eager = wrapper.launches - before
        before = wrapper.launches
        got = run(decoder, x)
        assert wrapper.launches - before == eager
        assert eager == DC.num_hidden_layers * want["steps"]
        assert_same(got, want)


def test_launch_records_nest_per_thread():
    class Wrapper:
        launches = 0

    with _build.captured_launches() as outer:
        _build.count_launch(Wrapper)
        with _build.captured_launches() as inner:
            _build.count_launch(Wrapper, 3)
        _build.count_launch(Wrapper)
    _build.count_launch(Wrapper, 5)
    assert (outer, inner, Wrapper.launches) == ({Wrapper: 2}, {Wrapper: 3}, 5)


@pytest.mark.parametrize("kind", list(DECODES))
def test_noise_is_drawn_as_the_eager_loop_draws_it(decoder, stub, kind):
    """``uniforms`` is called once a step run, in step order; a generator
    ends where the eager loop leaves it."""
    x = inputs(4)

    def logged(seed):
        gen = torch.Generator().manual_seed(seed)
        draw = decoding.torch_uniforms(gen, M, 2, DC.vocab_size, "cpu")
        calls = []

        def uniforms(step):
            calls.append(step)
            u = draw(step)
            return u if kind == "beam" else u[:, 0] if step else u
        return calls, uniforms

    for seed in (5, 6):
        runs = []
        for eager in (True, False):
            calls, uniforms = logged(seed)
            kw = {"uniforms": uniforms}
            if kind == "greedy":
                kw["stochastic"] = True
            runs.append((DECODES[kind](decoder, x, eager=eager, **kw), calls))
        (want, want_calls), (got, got_calls) = runs
        assert_same(got, want)
        assert got_calls == want_calls == list(range(want["steps"]))
    if kind == "beam":
        states = []
        for eager in (True, False):
            gen = torch.Generator().manual_seed(7)
            out = beam(decoder, x, eager=eager, generator=gen)
            states.append((out, gen.get_state()))
        assert_same(states[1][0], states[0][0])
        assert torch.equal(states[1][1], states[0][1])


def test_a_capture_error_raises_and_drops_the_shape(decoder, monkeypatch):
    class Failing(StubGraphs):
        def _capture(self, entry, pos):
            if pos == 3:
                raise RuntimeError("capture failed")
            return super()._capture(entry, pos)

    graphs = Failing()
    monkeypatch.setattr(decoding, "_graphs_for", lambda model, dev: graphs)
    with pytest.raises(RuntimeError, match="capture failed"):
        greedy(decoder, inputs(4))
    assert graphs.stats()["shapes"] == []


def test_the_key_follows_the_weights_storage(decoder):
    """An update in place keeps the key (the graphs read the same memory
    and see it); replaced storage makes another."""
    model = Rxn.random_init(1, DC, EC, device="cpu").text_encoder
    enc, mask = inputs(1)
    kv = decoding.precompute_cross_kv(model, DC, enc)

    def key():
        return decoding._shape_key("greedy", model, kv, mask, torch.float32,
                                   T=16)

    before = key()
    model.load_state_dict(decoder.state_dict())
    assert key() == before
    with torch.no_grad():
        model.bert.encoder.layer[0].attention.self.query.weight.data = (
            model.bert.encoder.layer[0].attention.self.query.weight.clone())
    assert key() != before


def tp_child(workdir: str) -> None:
    """Run in a subprocess: a world-1 gloo group, the decoder laid out by
    ``parallel.tp``, and which runner it gets."""
    from spmm_tpu_torch.parallel import mesh, multihost, tp

    multihost.initialize("cpu", init_method=f"file://{workdir}/store",
                         world_size=1, rank=0)
    try:
        mesh.set_mesh(1, 1)
        dec = Rxn.random_init(0, DC, EC, device="cpu").text_encoder.eval()
        card = torch.device("cuda")
        plain = decoding._graphs_for(dec, card) is decoding.graph_cache
        tp.apply_tp(dec)
        print("runner", plain, decoding._graphs_for(dec, card) is None)
    finally:
        torch.distributed.destroy_process_group()


def test_a_tp_decoder_takes_the_eager_runner(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"import test_torch_decode_graph as t; t.tp_child({str(tmp_path)!r})")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(here)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "runner True True" in out.stdout
