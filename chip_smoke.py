#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, PV->SMILES k-beam serving, at the full width of
the SPMM model (12-layer 768-wide decoder, 6-layer property encoder) with
random weights made from a seed, and holds every kernel of that path against
its plain PyTorch version.  Phases, in order; any failure exits non-zero:

  1. device   needs CUDA; prints the card's name and power limit
              (nvidia-smi), turns TF32 off;
  2. build    builds the kernels from the sources in the checkout;
  3. kernels  beam_decode_attention vs its plain version at the serving
              shapes (m=128, h=12, k=2, D=64, T=104) for f32/bf16/fp8
              caches, plus k=1 and k=5; times kernel, plain version, one
              scaled_dot_product_attention call, and computes the bound;
  4. exact    full-width fp32 beam search over 8 PVs, once through the
              kernel and once through the plain version: identical seqs,
              as initialised and with the [SEP] logit raised (harvest);
  5. serving  HTTP server -> Pv2SmilesService (bf16, k=2, batch 128):
              raw and partially masked requests, /healthz, a timed full
              batch, one kv_fp8 batch; the kernel's launches are counted
              over this phase, the main path;
  6. profile  one bf16 batch of 128 under torch.profiler: device busy
              share and the kernels that take the device time.

The last two lines are the kernels' JSON record and the device record.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import threading
import time

SEED = 0
SEP_BIAS = 0.7
KERNEL = {"name": "beam_decode_attention", "route": "cuda",
          "source": "spmm_tpu_torch/csrc/beam_decode_attention.cu",
          "replaces": "spmm_tpu/ops/decode_attention.py:57"}
# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def bits(x):
    import torch

    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        x.element_size()])


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn(i) over ``iters`` calls, by CUDA events."""
    import torch

    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 3: kernel vs plain version
# --------------------------------------------------------------------------- #


def kernel_inputs(dev, m, h, k, T, d, L, cache_dtype, pos, seed):
    """Random cache / q / k_new / v_new and an ancestry mask with random
    parents at every written position (t < pos)."""
    import torch

    from spmm_tpu_torch.ops.decode_attention import ancestry_mask, compute_dtype

    g = torch.Generator(device=dev).manual_seed(seed)
    cdt = compute_dtype(cache_dtype)
    cache = torch.randn((2, L, m, h, k, T, d), generator=g,
                        device=dev).to(cache_dtype)
    q, kn, vn = (torch.randn((m, h, k, d), generator=g, device=dev).to(cdt)
                 for _ in range(3))
    anc = torch.randint(0, k, (m, k, T), generator=g, device=dev)
    valid = (torch.arange(T, device=dev) < pos).expand(m, k, T)
    return q, kn, vn, cache, ancestry_mask(anc, valid).contiguous()


def compare_kernel(dev) -> dict:
    import torch

    from spmm_tpu_torch.ops.decode_attention import (
        beam_decode_attention, beam_decode_attention_reference)

    h, d, T, L = 12, 64, 104, 2
    cases = [(128, 2, dt) for dt in (torch.float32, torch.bfloat16,
                                     torch.float8_e4m3fn)]
    cases += [(64, 1, torch.float32), (16, 5, torch.float32)]
    worst: dict[str, float] = {}
    for m, k, cache_dtype in cases:
        tol = 1e-5 if cache_dtype == torch.float32 else 2e-2
        for pos in (1, 33, 103):
            q, kn, vn, cache, mask = kernel_inputs(
                dev, m, h, k, T, d, L, cache_dtype, pos, seed=pos + 7 * k)
            c_kernel, c_plain = cache.clone(), cache.clone()
            got = beam_decode_attention(q, kn, vn, c_kernel, mask, pos, 1)
            want = beam_decode_attention_reference(q, kn, vn, c_plain, mask,
                                                   pos, 1)
            sync(dev)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
            row_ok = (torch.equal(bits(c_kernel[0, 1, :, :, :, pos]),
                                  bits(kn.to(cache_dtype)))
                      and torch.equal(bits(c_kernel[1, 1, :, :, :, pos]),
                                      bits(vn.to(cache_dtype))))
            rest_ok = torch.equal(bits(c_kernel), bits(c_plain)) and \
                torch.equal(bits(c_kernel[..., :pos, :]),
                            bits(cache[..., :pos, :]))
            name = str(cache_dtype).replace("torch.", "")
            log(f"  m={m:3d} k={k} {name:14s} pos={pos:3d}  "
                f"max|ctx err|={err:.3e} (tol {tol:g})  append="
                f"{'bitwise' if row_ok else 'WRONG'}  rest="
                f"{'unchanged' if rest_ok else 'CHANGED'}")
            if not (ok and row_ok and rest_ok):
                fail(f"kernel disagrees with its plain version (m={m}, k={k},"
                     f" {name}, pos={pos})")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def time_kernel(dev) -> dict:
    """Serving shape, bf16, pos=103: kernel, plain version, one SDPA call,
    and the bound.  Launches walk the 12 layers, so each reads a layer's
    prefix (81 MB > the 50 MB L2) cold, as the decoder does."""
    import torch
    import torch.nn.functional as F

    from spmm_tpu_torch.ops.decode_attention import (
        beam_decode_attention, beam_decode_attention_reference)
    from spmm_tpu_torch.ops.masks import MASK_VALUE

    m, h, k, d, T, L, pos = 128, 12, 2, 64, 104, 12, 103
    dt = torch.bfloat16
    q, kn, vn, cache, mask = kernel_inputs(dev, m, h, k, T, d, L, dt, pos,
                                           seed=1)
    kernel_ms = cuda_ms(lambda i: beam_decode_attention(
        q, kn, vn, cache, mask, pos, i % L), iters=60)
    plain_ms = cuda_ms(lambda i: beam_decode_attention_reference(
        q, kn, vn, cache, mask, pos, i % L), iters=24)

    # one SDPA call over the gathered prefix plus the k self keys
    self_mask = torch.full((k, k), MASK_VALUE, device=dev).fill_diagonal_(0.0)
    amask = torch.cat([mask[..., :pos].reshape(m, k, k * pos),
                       self_mask.expand(m, k, k)], dim=-1)[:, None].to(dt)
    keys, vals = [], []
    for layer in range(L):
        keys.append(torch.cat([cache[0, layer, :, :, :, :pos].reshape(
            m, h, k * pos, d), kn], dim=2))
        vals.append(torch.cat([cache[1, layer, :, :, :, :pos].reshape(
            m, h, k * pos, d), vn], dim=2))
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, keys[i % L], vals[i % L], attn_mask=amask), iters=60)
    sdpa = F.scaled_dot_product_attention(q, keys[0], vals[0], attn_mask=amask)
    ref = beam_decode_attention(q, kn, vn, cache, mask, pos, 0)
    sdpa_err = (sdpa.float() - ref.float()).abs().max().item()

    # bytes the function must move: the prefix rows some beam attends
    # (K and V), the mask prefix, q/k_new/v_new, ctx and the appended rows
    esize = cache.element_size()
    live_rows = int((mask[..., :pos] > MASK_VALUE).any(dim=1).sum().item())
    small = m * h * k * d * esize
    nbytes = (2 * live_rows * h * d * esize + m * k * k * pos * 4
              + 3 * small + small + 2 * small)
    all_lane_bytes = 2 * m * h * k * pos * d * esize
    flops = 4 * m * h * k * (k * pos + 1) * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "live_rows": live_rows,
        "all_rows": m * k * pos,
        "bound_ms_all_lanes": all_lane_bytes / HBM_BYTES_PER_S * 1e3,
        "sdpa_vs_kernel_max_abs": sdpa_err,
    }


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32 exactness, kernel vs plain
# --------------------------------------------------------------------------- #


def exactness(dev, model, decoder, n_pv: int = 8, max_steps: int = 100) -> dict:
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec, beam_search_batched
    from spmm_tpu_torch.inference.pv2smiles import encode_pv
    from spmm_tpu_torch.ops.decode_attention import beam_decode_attention

    cfg = model.text_cfg
    pv = np.random.default_rng(SEED).normal(size=(n_pv, 53)).astype(np.float32)
    with torch.no_grad():
        enc = encode_pv(model, torch.as_tensor(pv, device=dev), None)
    cross_mask = torch.ones(enc.shape[:2], dtype=torch.int32, device=dev)
    out = {}
    for attention in ("kernel", "plain"):
        spec = BeamSpec(k=2, stop_count=2, max_steps=max_steps,
                        attention=attention)
        before = beam_decode_attention.launches
        t0 = time.perf_counter()
        res = beam_search_batched(decoder, cfg, enc, cross_mask, spec)
        sync(dev)
        out[attention] = (res, time.perf_counter() - t0,
                          beam_decode_attention.launches - before)
    (rk, tk, lk), (rp, tp, lp) = out["kernel"], out["plain"]
    if rk["seqs"].shape != (n_pv, 2, spec.max_len):
        fail(f"seqs shape {tuple(rk['seqs'].shape)}")
    if torch.isnan(rk["logp"]).any():
        fail("NaN logp")
    if not (torch.equal(rk["seqs"], rp["seqs"])
            and torch.equal(rk["n_finished"], rp["n_finished"])):
        fail("fp32 seqs / n_finished differ between kernel and plain paths")
    lp_err = (rk["logp"] - rp["logp"]).abs().nan_to_num(0.0).max().item()
    if lp_err > 1e-4:
        fail(f"fp32 logp differ by {lp_err:.3e} > 1e-4")
    if lk != cfg.num_hidden_layers * rk["steps"] or lp != 0:
        fail(f"kernel launches {lk} (plain run {lp}) for {rk['steps']} steps "
             f"x {cfg.num_hidden_layers} layers")
    return {"steps": rk["steps"], "n_finished": rk["n_finished"].tolist(),
            "logp_max_abs_diff": lp_err, "kernel_s": tk, "plain_s": tp,
            "launches": lk}


# --------------------------------------------------------------------------- #
# phase 5: serving through the HTTP front-end
# --------------------------------------------------------------------------- #


def _post(url: str, payload: dict):
    import urllib.request

    req = urllib.request.Request(
        url + "/pv2smiles", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _concurrent(url: str, payloads: list) -> list:
    results: list = [None] * len(payloads)

    def client(i):
        try:
            results[i] = _post(url, payloads[i])
        except Exception as exc:  # noqa: BLE001 — checked below
            results[i] = (None, repr(exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    for i, (status, body) in enumerate(results):
        if status != 200 or not isinstance(body.get("smiles"), str):
            fail(f"request {i}: {status} {body}")
    return [body["smiles"] for _, body in results]


def serving(dev, model, batch: int = 128) -> dict:
    import urllib.request

    import numpy as np

    from spmm_tpu_torch.cli._common import load_stats, make_tokenizer
    from spmm_tpu_torch.cli.serve import make_server
    from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
    from spmm_tpu_torch.serving import Pv2SmilesService

    tok, stats = make_tokenizer(), load_stats()
    rng = np.random.default_rng(SEED + 1)

    def raw_pv():
        return [float(v) for v in stats.mean + 0.5 * stats.std
                * rng.normal(size=53).astype(np.float32)]

    # a wait long enough that a wave of concurrent requests fills one batch
    svc = Pv2SmilesService(model, tok, k=2, batch_size=batch,
                           max_wait_ms=1500.0, device=dev)
    svc_fp8 = Pv2SmilesService(model, tok, k=2, batch_size=batch,
                               max_wait_ms=1500.0, kv_fp8=True, device=dev)
    server = make_server({"pv2smiles": svc}, "127.0.0.1", 0, stats=stats)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        partial = raw_pv()
        for i in range(20, 53):
            partial[i] = None
        wave1 = [{"pv": raw_pv(), "normalized": False} for _ in range(16)]
        wave1.append({"pv": partial})
        wave2 = [{"pv": raw_pv()} for _ in range(batch)]

        beam_decode_attention.launches = 0      # the main path starts here
        t0 = time.perf_counter()
        first = _concurrent(url, wave1)
        t1 = time.perf_counter()
        secs_before = svc.stats["batch_seconds"]
        batches_before = svc.stats["batches"]
        full = _concurrent(url, wave2)
        t2 = time.perf_counter()
        launches = beam_decode_attention.launches   # ... and ends here
        wave2_batches = svc.stats["batches"] - batches_before
        per_batch_s = ((svc.stats["batch_seconds"] - secs_before)
                       / wave2_batches)

        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        n_req = health["services"]["pv2smiles"]["requests"]
        if n_req != len(wave1) + len(wave2):
            fail(f"/healthz counts {n_req} requests, sent "
                 f"{len(wave1) + len(wave2)}")
        if launches <= 0 or launches % model.text_cfg.num_hidden_layers:
            fail(f"serving ran {launches} kernel launches")

        fp8_before = svc_fp8.stats["batch_seconds"]
        fp8 = svc_fp8.map([np.asarray(stats.normalize(
            np.asarray(p["pv"], np.float32))) for p in wave2])
        fp8_s = svc_fp8.stats["batch_seconds"] - fp8_before
        if not all(isinstance(s, str) for s in fp8):
            fail("kv_fp8 batch returned a non-string")
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        svc_fp8.close()
    return {
        "launches": launches, "batches": health["services"]["pv2smiles"][
            "batches"], "requests": n_req,
        "wave1_wall_s": t1 - t0, "wave2_wall_s": t2 - t1,
        "wave2_batches": wave2_batches, "batch_call_s": per_batch_s,
        "mol_per_s": batch / per_batch_s, "kv_fp8_batch_s": fp8_s,
        "kv_fp8_mol_per_s": batch / fp8_s,
        "examples": first[:2] + full[:1], "kv_fp8_same_as_bf16": sum(
            a == b for a, b in zip(fp8, full)),
    }


# --------------------------------------------------------------------------- #
# phase 6: where one serving batch spends its time
# --------------------------------------------------------------------------- #


def profile_batch(dev, model, batch: int = 128) -> dict:
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch, decoder_for
    from spmm_tpu_torch.utils.profiling import device_breakdown

    decoder = decoder_for(model, bf16=True)
    pv = torch.as_tensor(np.random.default_rng(SEED + 2).normal(
        size=(batch, 53)).astype(np.float32), device=dev)
    mask = torch.zeros_like(pv)
    spec = BeamSpec(k=2, stop_count=2)
    out = {}

    def run():
        out["res"] = _beam_batch(model, decoder, pv, mask, spec)

    run()                                         # warm-up
    sync(dev)
    t0 = time.perf_counter()
    run()
    sync(dev)
    unprofiled = time.perf_counter() - t0
    prof = device_breakdown(run)
    return dict(prof, steps=out["res"]["steps"], unprofiled_wall_s=unprofiled)


# --------------------------------------------------------------------------- #


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from spmm_tpu_torch.models.spmm import SPMM
        from spmm_tpu_torch.ops import decode_attention
        from spmm_tpu_torch.utils.device import resolve_device
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2

    # ---- 1. device ----
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    from spmm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    decode_attention.build()
    log(f"[build] beam_decode_attention in {time.perf_counter() - t0:.1f} s")
    report = _build.library_path("beam_decode_attention").with_suffix(".log")
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain ----
    log("[kernels] beam_decode_attention vs plain version")
    worst = compare_kernel(dev)
    timing = time_kernel(dev)
    log(f"  serving shape bf16 pos=103: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} ms, "
        f"bound {timing['bound_ms']:.4f} ms ({timing['live_rows']}/"
        f"{timing['all_rows']} prefix rows attended; all-lane bound "
        f"{timing['bound_ms_all_lanes']:.4f} ms)")

    # ---- 4. full-width fp32 exactness ----
    t0 = time.perf_counter()
    model = SPMM.random_init(SEED, device=dev)
    log(f"[exact] full-width SPMM random init in "
        f"{time.perf_counter() - t0:.1f} s")
    # as initialised no beam emits [SEP] (the live-beam fallback after 100
    # steps); a copy with the [SEP] logit raised exercises the harvest
    sep_biased = copy.deepcopy(model.text_encoder)
    with torch.no_grad():
        sep_biased.cls.predictions.bias[3] += SEP_BIAS
    exact = {}
    for name, decoder in (("as_init", model.text_encoder),
                          ("sep_biased", sep_biased)):
        res = exact[name] = exactness(dev, model, decoder)
        log(f"  {name}: fp32 k=2 x 8 PVs, {res['steps']} steps, seqs "
            f"identical, n_finished {res['n_finished']}, max |logp diff| "
            f"{res['logp_max_abs_diff']:.2e}, {res['launches']} launches; "
            f"kernel path {res['kernel_s']:.2f} s, plain {res['plain_s']:.2f} s")
    del sep_biased

    # ---- 5. serving (the main path) ----
    log("[serving] HTTP -> Pv2SmilesService (bf16, k=2, batch 128)")
    serve = serving(dev, model)
    log(f"  {serve['requests']} requests in {serve['batches']} batches, "
        f"{serve['launches']} kernel launches; batch of {128}: "
        f"{serve['batch_call_s']:.3f} s = {serve['mol_per_s']:.1f} mol/s "
        f"({serve['wave2_batches']} batch(es), wall incl. HTTP "
        f"{serve['wave2_wall_s']:.3f} s); kv_fp8 batch "
        f"{serve['kv_fp8_batch_s']:.3f} s = {serve['kv_fp8_mol_per_s']:.1f} "
        f"mol/s ({serve['kv_fp8_same_as_bf16']}/128 same as bf16)")
    log(f"  examples: {serve['examples']}")

    # ---- 6. profile ----
    prof = profile_batch(dev, model)
    busy = prof["busy_share"]
    log(f"[profile] one bf16 batch of 128, {prof['steps']} steps: wall "
        f"{prof['unprofiled_wall_s']:.3f} s unprofiled, {prof['wall_s']:.3f} "
        f"s profiled; device busy "
        + ("not measured (no device events in the trace)" if busy is None
           else f"{prof['device_busy_s']:.3f} s = {100 * busy:.1f}% of the "
                f"profiled wall, {prof['device_events']} device events"))
    for row in prof["top"]:
        log(f"  {row['ms']:9.3f} ms {row['count']:6d}x  {row['name']}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"serving": serve, "exact": exact, "profile": prof}))
    record = dict(KERNEL, launches=serve["launches"],
                  max_abs_err=worst["bfloat16"],
                  max_abs_err_by_cache_dtype=worst, **timing)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
