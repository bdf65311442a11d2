"""The split-TF32 linear (spmm_tpu_torch/ops/split_gemm.py) on the CPU: its
plain version and the routing of ``models.bert.Linear``.  No JAX.

- TF32 rounding by bit operations is ``cvt.rna.tf32.f32``'s: to nearest,
  ties away from zero, 13 low bits clear.
- The three products (x_hi W_hi, x_hi W_lo, x_lo W_hi, the low parts
  scaled by 2^11) against an fp64 product at the BERT layers' widths (K and
  N of 768 and 3,072, a ragged M): their relative RMS and largest error at
  most 2x those of ``F.linear`` in fp32 (fp32's accuracy held), while the
  one TF32 product is far worse (TF32's 10 mantissa bits).
- A weight's parts are made once and made again once it changes.
- Routing: a K = 1 or N = 1 linear, a bf16 input, a call that needs a
  gradient, a module in training mode, autocast, TF32 allowed, a linear
  under FSDP and any CPU tensor keep ``F.linear``; a pretraining model
  (the momentum twins' no-grad forward included) routes nothing; the
  state-dict keys of SPMM and the reaction model are ``nn.Linear``'s;
  ``predict_pv`` on the CPU is bit for bit what it was with ``nn.Linear``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models import bert as bert_mod
from spmm_tpu_torch.models import spmm as spmm_mod
from spmm_tpu_torch.models.bert import Linear
from spmm_tpu_torch.ops import split_gemm
from spmm_tpu_torch.ops.split_gemm import (
    LO_SCALE,
    split_linear,
    split_linear_reference,
    split_tf32,
    split_weight,
    tf32_round,
    weight_parts,
)

TINY = dict(vocab_size=300, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=128, type_vocab_size=2, fusion_layer=1,
            encoder_width=64)


def _configs():
    text = BertArchConfig(**TINY)
    prop = BertArchConfig(**dict(TINY, vocab_size=1, num_hidden_layers=2,
                                 fusion_layer=2, add_cross_attention=False))
    return text, prop


def _rna_tf32(v: float) -> float:
    """TF32 rounding of one fp32 value in exact arithmetic: to 11
    significant bits, ties away from zero."""
    if v == 0:
        return v
    m, e = np.frexp(np.float64(v))              # v = m 2^e, 0.5 <= |m| < 1
    scaled = abs(m) * 2.0 ** 11                 # 11 significant bits
    r = np.floor(scaled + 0.5)                  # ties away from zero
    return float(np.copysign(r * 2.0 ** (e - 11), v))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_round_is_cvt_rna(seed):
    g = np.random.default_rng(seed)
    x = g.normal(size=4096).astype(np.float32) * np.float32(
        10.0) ** g.integers(-20, 20, size=4096).astype(np.float32)
    # exact ties: an 11-bit value plus half a unit, both signs
    ties = np.array([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11),
                     3.0 + 2.0 ** -10, 1.0 + 2.0 ** -10], dtype=np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, 1.0, -2.5])])
    got = tf32_round(torch.from_numpy(x)).numpy()
    want = np.array([_rna_tf32(float(v)) for v in x], dtype=np.float32)
    assert np.array_equal(got, want)
    assert not (torch.from_numpy(got).view(torch.int32) & 0x1FFF).any()
    assert got[-7] == np.float32(1.0 + 2.0 ** -10)       # away from zero
    assert got[-6] == np.float32(-(1.0 + 4 * 2.0 ** -11))


def test_split_parts_sum_to_x():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(10000, generator=g) * 3
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    rel = ((hi.double() + lo.double() / LO_SCALE) - x.double()).abs() \
        / x.double().abs()
    assert rel.max() <= 2.0 ** -21                 # 22 of fp32's 24 bits
    assert (x.double() - hi.double()).abs().max() > 0


def _errors(y: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = y.double() - ref
    return ((d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item(),
            (d.abs().max() / ref.abs().max()).item())


@pytest.mark.parametrize("k", [768, 3072])
@pytest.mark.parametrize("n", [768, 3072])
def test_three_products_hold_fp32_accuracy(k, n):
    torch.set_num_threads(2)
    g = torch.Generator().manual_seed(k + n)
    m = 67                                          # ragged rows
    x = torch.randn(m, k, generator=g)
    w = torch.randn(n, k, generator=g) * 0.02
    b = torch.randn(n, generator=g) * 0.02
    ref = F.linear(x.double(), w.double(), b.double())
    rms, big = _errors(split_linear_reference(x, w, b), ref)
    rms32, big32 = _errors(F.linear(x, w, b), ref)
    assert rms <= 2 * rms32 and big <= 2 * big32, (rms, rms32, big, big32)
    rms1, _ = _errors(F.linear(tf32_round(x), tf32_round(w), b), ref)
    assert rms1 > 30 * rms32                       # one TF32 product is not


def test_split_linear_refuses_a_cpu_tensor():
    """The kernel's wrapper runs on a card only; its plain version is
    ``split_linear_reference``."""
    w = torch.randn(96, 64)
    with pytest.raises(TypeError, match="fp32 CUDA"):
        split_linear(torch.randn(2, 64), w)


def test_weight_parts_are_made_once_and_again_after_a_change():
    lin = nn.Linear(64, 128)
    first = weight_parts(lin.weight)
    assert weight_parts(lin.weight) is first
    assert torch.equal(first, split_weight(lin.weight))
    assert first.shape == (256, 64)
    with torch.no_grad():
        lin.weight.mul_(2)                           # in place: _version
    second = weight_parts(lin.weight)
    assert second is not first and torch.equal(second,
                                               split_weight(lin.weight))
    twin = copy.deepcopy(lin)                        # another tensor
    assert weight_parts(twin.weight) is not second
    key = id(twin.weight)
    del twin
    assert key not in split_gemm._parts              # freed with its weight


def test_split_linear_refuses_a_call_that_needs_a_gradient():
    w = torch.randn(128, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        split_gemm.check_no_grad("split_linear", torch.randn(2, 64), w)


@pytest.mark.parametrize("n,k,routed", [(768, 768, True), (3072, 768, True),
                                        (768, 3072, True), (768, 1, False),
                                        (1, 768, False), (300, 768, False),
                                        (256, 768, False), (2, 1536, False),
                                        (192, 48, False), (96, 32, True)])
def test_widths_the_kernel_takes(n, k, routed):
    assert split_gemm.takes(n, k) is routed


@pytest.mark.parametrize("grad", [True, False])
def test_a_cpu_tensor_keeps_f_linear(grad, monkeypatch):
    seen = []
    monkeypatch.setattr(bert_mod, "split_linear",
                        lambda *a: seen.append(a) or F.linear(*a))
    lin = Linear(64, 128)
    x = torch.randn(3, 64)
    with torch.set_grad_enabled(grad):
        assert torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))
    assert not seen


@pytest.mark.parametrize("case,routed", [
    ("fp32", True), ("bf16", False), ("k1", False), ("n1", False),
    ("n300", False), ("x_requires_grad", False), ("grad_mode", False),
    ("training", False), ("autocast", False), ("tf32", False),
    ("not_split", False)])
def test_the_route_besides_the_device(case, routed):
    """``Linear.routes``: an fp32 call at widths the kernel takes, in eval
    mode, routes; a K = 1 or N = 1 linear (``property_embed``, the MTR
    head's last layer), the vocabulary's 300 columns, bf16, a call that
    needs a gradient, a module in training mode, a call under autocast or
    with TF32 allowed, and a linear whose ``split`` is cleared (FSDP) keep
    ``F.linear``."""
    n, k = {"k1": (768, 1), "n1": (1, 768), "n300": (300, 64)}.get(
        case, (192, 64))
    lin = Linear(k, n).train(case == "training")
    lin.split = case != "not_split"
    x = torch.randn(3, k, requires_grad=case == "x_requires_grad")
    if case == "bf16":
        lin, x = lin.to(torch.bfloat16), x.to(torch.bfloat16)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = case == "tf32"
        with torch.set_grad_enabled(case in ("x_requires_grad",
                                             "grad_mode")), \
                torch.autocast("cpu", dtype=torch.bfloat16,
                               enabled=case == "autocast"):
            assert lin.routes(x) is routed
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


WIDE = dict(TINY, hidden_size=96, intermediate_size=192, encoder_width=96)


def _wide_linears(model: nn.Module) -> list:
    """(module, fp32 input) of every Linear whose widths the kernel takes."""
    return [(m, torch.randn(2, m.in_features)) for m in model.modules()
            if isinstance(m, Linear) and split_gemm.takes(*m.weight.shape)]


def test_a_pretraining_model_routes_nothing():
    """A pretraining model is in training mode, its momentum twins too, so
    the twins' no-grad forward (and the bf16 step's autocast) stays on
    ``F.linear``; the same model in eval mode would route."""
    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import init_pretrain_state

    text = BertArchConfig(**WIDE)
    prop = BertArchConfig(**dict(WIDE, vocab_size=1, num_hidden_layers=2,
                                 fusion_layer=2, add_cross_attention=False))
    model = init_pretrain_state(0, PretrainConfig(embed_dim=16,
                                                  queue_size=64),
                                text, prop, device="cpu")
    linears = _wide_linears(model)
    twins = _wide_linears(model.text_encoder_m)
    assert len(linears) > 40 and twins
    with torch.no_grad():
        assert not any(m.routes(x) for m, x in linears)
        model.eval()
        assert all(m.routes(x) for m, x in linears)


def test_fsdp_clears_every_linear_s_split():
    """``parallel.fsdp.apply_fsdp`` clears ``split`` on every Linear of the
    model it shards: FSDP refills a gathered weight in place and keeps its
    ``_version``, so the kernel's kept parts could not see it change.  On
    a world-1 gloo group, in eval mode and under no_grad, nothing routes."""
    import socket

    import torch.distributed as dist

    from spmm_tpu_torch.parallel import fsdp, mesh
    from spmm_tpu_torch.training.pretrain import PretrainModel

    text = BertArchConfig(**WIDE)
    prop = BertArchConfig(**dict(WIDE, vocab_size=1, num_hidden_layers=2,
                                 fusion_layer=2, add_cross_attention=False))
    model = PretrainModel(text, prop, 16, 64)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        fsdp.dp_fsdp_mesh(1, 1)
        fsdp.apply_fsdp(model)
        linears = [m for m in model.modules() if isinstance(m, Linear)]
        assert len(linears) > 40
        assert all(m.split is False for m in linears)
        model.eval()
        with torch.no_grad():
            assert not any(m.routes(torch.randn(2, m.in_features))
                           for m in linears)
    finally:
        mesh.clear_mesh()
        dist.destroy_process_group()
    assert Linear(64, 96).split is True


def _keys(model: nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_state_dict_keys_are_nn_linear_s(monkeypatch):
    from spmm_tpu_torch.models.rxn import Rxn

    text, prop = _configs()
    mine = [_keys(spmm_mod.SPMM(text, prop, with_pretrain_heads=True)),
            _keys(Rxn(text, dataclasses.replace(text, fusion_layer=3,
                                                add_cross_attention=False)))]
    linears = [m for m in spmm_mod.SPMM(text, prop).modules()
               if isinstance(m, nn.Linear)]
    assert linears and all(type(m) is Linear for m in linears)
    monkeypatch.setattr(bert_mod, "Linear", nn.Linear)
    monkeypatch.setattr(spmm_mod, "Linear", nn.Linear)
    plain = [_keys(spmm_mod.SPMM(text, prop, with_pretrain_heads=True)),
             _keys(Rxn(text, dataclasses.replace(text, fusion_layer=3,
                                                 add_cross_attention=False)))]
    assert mine == plain


def test_predict_pv_on_the_cpu_is_nn_linear_s(monkeypatch):
    from spmm_tpu_torch.inference.smiles2pv import predict_pv

    torch.set_num_threads(1)
    text, prop = _configs()
    model = spmm_mod.SPMM.random_init(5, text, prop, device="cpu")
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(4, 300, (4, 12), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 9:] = 0
    got = predict_pv(model, ids, mask, n_properties=6, device="cpu")
    monkeypatch.setattr(Linear, "forward", nn.Linear.forward)
    want = predict_pv(model, ids, mask, n_properties=6, device="cpu")
    assert torch.equal(got, want)
