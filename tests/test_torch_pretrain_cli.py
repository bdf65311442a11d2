"""Port parity and drives of pretraining's data, checkpoints and CLIs
(spmm_tpu_torch.data.pipeline.batch_pretrain, training.pretrain.
pretrain_state_from_reference, checkpoint.io, cli.pretrain,
cli.convert_checkpoint), at a tiny size on the CPU.

- ``batch_pretrain`` yields JAX's batches, equal, for the same seed and
  ``skip_batches`` (the same numpy shuffle);
- ``pretrain_state_from_reference`` on the hand-written reference state of
  tests/test_torch_checkpoint.py (its queues given the width of the
  pretrain heads, embed 256, which the port's strict load checks and
  JAX's does not): loads strictly, drops the extra ``*_m`` entries,
  raises on a missing twin and on a queue of another size, and equals
  JAX's ``pretrain_state_from_reference`` of the same file;
- two steps, a save, a restore into a fresh model and optimizer and a
  third step equal three uninterrupted steps, dropout on, exactly;
- ``cli.pretrain --device cpu`` for 4 steps (checkpoints at 2 and 4), and
  a resume from step 2 to step 4 that ends where the first run ended;
- ``cli.convert_checkpoint`` both ways: ``--to_torch``'s key set is
  ``export_spmm_state_dict``'s and loads into an inference ``SPMM``
  strictly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from spmm_tpu.checkpoint.convert import load_torch_state_dict
from spmm_tpu.checkpoint.export import export_spmm_state_dict
from spmm_tpu.configs import PretrainConfig as JaxPcfg
from spmm_tpu.data import datasets as jdatasets
from spmm_tpu.data import pipeline as jpipeline
from spmm_tpu.tokenizer import SmilesTokenizer as JaxTokenizer
from spmm_tpu.training import pretrain as jpre

from spmm_tpu_torch.checkpoint.convert import (
    load_reference_checkpoint, load_spmm_checkpoint,
    pretrain_state_dict_from_jax)
from spmm_tpu_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg
from spmm_tpu_torch.configs import PretrainConfig
from spmm_tpu_torch.data.datasets import PretrainDataset
from spmm_tpu_torch.data.pipeline import batch_pretrain
from spmm_tpu_torch.models.spmm import SPMM
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.training import pretrain

from test_torch_checkpoint import reference_style_state
from torch_parity import jax_configs, jax_tree, torch_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "s2p_input.txt")
TINY = dict(vocab_size=300, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2, fusion_layer=2,
            encoder_width=32)
TTEXT = TorchCfg(**TINY, add_cross_attention=True)
TPROP = TorchCfg(**{**TINY, "vocab_size": 1, "num_hidden_layers": 2},
                 add_cross_attention=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is several times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The example SMILES cycled to 40 lines, and raw property vectors from
    a seed, as (corpus path, property cache path)."""
    d = tmp_path_factory.mktemp("corpus")
    with open(EXAMPLES) as f:
        smiles = [line.strip() for line in f if line.strip()]
    lines = [smiles[i % len(smiles)] for i in range(40)]
    path = d / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    pv = np.random.default_rng(0).normal(size=(40, 53)) * 3.0 + 10.0
    cache = d / "corpus.pv.npz"
    np.savez(cache, pv=pv.astype(np.float32))
    return str(path), str(cache)


@pytest.mark.parametrize("seed,skip", [(0, 0), (3, 0), (3, 2)])
def test_batch_pretrain_matches_jax(corpus, seed, skip):
    path, cache = corpus
    want = list(jpipeline.batch_pretrain(
        JaxTokenizer(), jdatasets.PretrainDataset(path, property_cache=cache),
        6, seed=seed, skip_batches=skip))
    got = list(batch_pretrain(
        SmilesTokenizer(), PretrainDataset(path, property_cache=cache), 6,
        seed=seed, skip_batches=skip))
    assert len(got) == len(want) == 40 // 6 - skip
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def reference_file(tmp_path, drop=(), queues=True) -> str:
    """The hand-written reference pretrain state, its queues [256, 64]
    (the pretrain heads' width) and queue_ptr 5, with ``drop`` removed."""
    state = reference_style_state(jax_tree(seed=3))
    if queues:
        g = torch.Generator().manual_seed(4)
        state["prop_queue"] = torch.randn(256, 64, generator=g)
        state["text_queue"] = torch.randn(256, 64, generator=g)
        state["queue_ptr"] = torch.tensor([5])
    else:
        for k in ("prop_queue", "text_queue", "queue_ptr"):
            del state[k]
    for k in drop:
        del state[k]
    path = tmp_path / "checkpoint_SPMM.ckpt"
    torch.save({"state_dict": state}, path)
    return str(path)


def port_from_reference(path, **kw) -> pretrain.PretrainModel:
    return pretrain.pretrain_state_from_reference(
        load_reference_checkpoint(path), PretrainConfig(queue_size=64, **kw),
        *torch_configs(), device="cpu")


def test_pretrain_state_from_reference_matches_jax(tmp_path):
    path = reference_file(tmp_path)
    model = port_from_reference(path)
    tc, pc = jax_configs()
    want = jpre.pretrain_state_from_reference(
        load_torch_state_dict(path), JaxPcfg(queue_size=64), tc, pc)
    want = pretrain_state_dict_from_jax(
        jax.tree.map(np.asarray, {k: want[k] for k in ("params", "ema",
                                                       "queue")}),
        *torch_configs())
    got = model.state_dict()
    assert set(got) == set(want)
    for name, val in want.items():
        assert torch.equal(got[name], val), name
    assert got["queue_ptr"].tolist() == [5]
    # the reference's other momentum entries are not part of the state
    assert not any(k.startswith(("itm_head_m", "property_embed_m",
                                 "property_mtr_head_m")) for k in got)


def test_pretrain_state_from_reference_refuses_bad_files(tmp_path):
    with pytest.raises(RuntimeError, match="text_proj_m.weight"):
        port_from_reference(reference_file(tmp_path,
                                           drop=("text_proj_m.weight",)))
    with pytest.raises(ValueError, match="queue size"):
        pretrain.pretrain_state_from_reference(
            load_reference_checkpoint(reference_file(tmp_path)),
            PretrainConfig(queue_size=128), *torch_configs(), device="cpu")


def test_pretrain_state_from_reference_without_queues(tmp_path):
    model = port_from_reference(reference_file(tmp_path, queues=False))
    assert model.prop_queue.shape == (256, 64)
    torch.testing.assert_close(
        torch.linalg.vector_norm(model.text_queue, dim=0), torch.ones(64))
    assert model.queue_ptr.tolist() == [0]


def tiny_batches(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, 300, size=(4, 10))
        ids[:, 0] = 2
        mask = np.ones((4, 10), np.int64)
        mask[2, 6:] = 0
        out.append({"prop": torch.tensor(rng.normal(size=(4, 53)),
                                         dtype=torch.float32),
                    "ids": torch.tensor(ids * mask),
                    "mask": torch.tensor(mask)})
    return out


def test_resume_equals_uninterrupted(tmp_path):
    pcfg = PretrainConfig(embed_dim=16, queue_size=64, lr=1e-3)
    batches = tiny_batches(3)

    def run(model, opt_step, steps):
        for s in steps:
            opt_step(s, batches[s],
                     pretrain.step_generator(7, s, torch.device("cpu")))

    straight = pretrain.init_pretrain_state(1, pcfg, TTEXT, TPROP, "cpu")
    opt_a, step_a = pretrain.make_pretrain_step(straight, pcfg, 2)
    run(straight, step_a, range(3))

    first = pretrain.init_pretrain_state(1, pcfg, TTEXT, TPROP, "cpu")
    opt_b, step_b = pretrain.make_pretrain_step(first, pcfg, 2)
    run(first, step_b, range(2))
    save_checkpoint(str(tmp_path / "step_2.pt"), first, opt_b, 2)
    assert not os.path.exists(tmp_path / "step_2.pt.tmp")

    resumed = pretrain.init_pretrain_state(9, pcfg, TTEXT, TPROP, "cpu")
    opt_c, step_c = pretrain.make_pretrain_step(resumed, pcfg, 2)
    assert restore_checkpoint(str(tmp_path / "step_2.pt"), resumed,
                              opt_c) == 2
    run(resumed, step_c, [2])
    for name, val in straight.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], val), name
    for pa, pc in zip(opt_a.param_groups[0]["params"],
                      opt_c.param_groups[0]["params"]):
        for key, val in opt_a.state[pa].items():
            assert torch.equal(opt_c.state[pc][key], val), key


@pytest.fixture
def tiny_cli(monkeypatch):
    from spmm_tpu_torch.cli import convert_checkpoint
    from spmm_tpu_torch.cli import pretrain as cli

    for mod, (tc, pc) in ((cli, (TTEXT, TPROP)),
                          (convert_checkpoint, torch_configs())):
        monkeypatch.setattr(mod, "text_config", lambda tc=tc: tc)
        monkeypatch.setattr(mod, "property_config", lambda pc=pc: pc)
    return cli, convert_checkpoint


def test_pretrain_cli_runs_and_resumes_on_cpu(tmp_path, corpus, tiny_cli):
    cli, _ = tiny_cli
    path, cache = corpus
    common = ["--data_path", path, "--property_cache", cache,
              "--batch_size", "8", "--queue_size", "64", "--max_steps", "4",
              "--save_every", "2", "--seed", "5", "--device", "cpu"]
    first, second = tmp_path / "first", tmp_path / "second"
    cli.main(common + ["--output_dir", str(first)])
    assert sorted(os.listdir(first)) == ["metrics.jsonl", "run_meta.json",
                                         "step_2.pt", "step_4.pt"]
    with open(first / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and not r["skipped"] for r in records)
    with open(first / "run_meta.json") as f:
        assert json.load(f) == {"global_bs": 8, "seed": 5, "n_dev": 1,
                                "batch_size": 8}

    # 40 lines make 5 steps an epoch: the resume skips two batches of it
    cli.main(common + ["--output_dir", str(second),
                       "--resume", str(first / "step_2.pt")])
    with open(second / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [3, 4]
    a = torch.load(first / "step_4.pt", weights_only=True)
    b = torch.load(second / "step_4.pt", weights_only=True)
    assert a["step"] == b["step"] == 4
    for name, val in a["state_dict"].items():
        assert torch.equal(b["state_dict"][name], val), name


def test_convert_checkpoint_both_ways(tmp_path, tiny_cli):
    _, conv = tiny_cli
    ref = reference_file(tmp_path)
    resumable = str(tmp_path / "resumable.pt")
    conv.main(["--torch_ckpt", ref, "--out", resumable,
               "--as_pretrain_state", "--queue_size", "64"])
    want = port_from_reference(ref)
    model = pretrain.PretrainModel(*torch_configs(), 256, 64)
    opt = pretrain.make_pretrain_optimizer(model, PretrainConfig())
    assert restore_checkpoint(resumable, model, opt) == 0
    assert not opt.state
    for name, val in want.state_dict().items():
        assert torch.equal(model.state_dict()[name], val), name

    exported = str(tmp_path / "exported.ckpt")
    conv.main(["--torch_ckpt", resumable, "--out", exported, "--to_torch"])
    state = torch.load(exported, weights_only=True)["state_dict"]
    tree = jax_tree(seed=3)
    tree["momentum"] = {k: tree[k] for k in pretrain.EMA_KEYS}
    assert set(state) == set(export_spmm_state_dict(tree, *jax_configs()))
    for name, val in state.items():
        assert torch.equal(val, want.state_dict()[name]), name
    spmm = load_spmm_checkpoint(SPMM(*torch_configs()), exported)
    assert torch.equal(spmm.property_cls, want.property_cls)


def test_convert_checkpoint_needs_one_direction(tiny_cli):
    _, conv = tiny_cli
    with pytest.raises(SystemExit):
        conv.main(["--torch_ckpt", "a", "--out", "b"])
    with pytest.raises(SystemExit):
        conv.main(["--torch_ckpt", "a", "--out", "b", "--to_torch",
                   "--as_pretrain_state"])


def test_pretrain_config_fields_reach_the_cli_step(tmp_path, corpus,
                                                   tiny_cli, monkeypatch):
    """--bf16, --remat and --accum reach the step's config."""
    cli, _ = tiny_cli
    seen = {}
    real = cli.make_pretrain_step

    def spy(model, pcfg, steps_per_epoch, accum=1, **kwargs):
        seen.update(dataclasses.asdict(pcfg), accum=accum)
        return real(model, pcfg, steps_per_epoch, accum=accum, **kwargs)

    monkeypatch.setattr(cli, "make_pretrain_step", spy)
    path, cache = corpus
    cli.main(["--data_path", path, "--property_cache", cache,
              "--batch_size", "8", "--queue_size", "64", "--max_steps", "1",
              "--bf16", "--remat", "--accum", "2", "--device", "cpu",
              "--output_dir", str(tmp_path / "out")])
    assert seen["bf16_compute"] and seen["remat"] and seen["accum"] == 2
    assert os.path.exists(tmp_path / "out" / "step_1.pt")


def test_profiling_helpers_on_cpu(tmp_path):
    """count_flops, mfu and trace, as the pretrain CLI and chip_smoke use
    them (here on CPU tensors: a count, no device time); a span inside
    ``trace`` is a range of its trace.json."""
    from spmm_tpu_torch.utils import profiling

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, flops = profiling.count_flops(lambda: a @ b)
    assert out.shape == (8, 4) and flops == 2 * 8 * 16 * 4
    assert profiling.mfu(flops, 1e-6, 2, 1e9) == pytest.approx(0.512)
    assert profiling.mfu(None, 1.0) is None
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("spmm.test.product"):
            a @ b
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert [ev for ev in events if ev.get("name") == "spmm.test.product"]
