"""Entry points of the parallel paths: a full-width loss for one card and
a multi-process dry run of every parallel path (counterpart of the JAX
package's ``__graft_entry__.py``).

- :func:`entry` returns ``(fn, args)``: the full-width ``PretrainModel``'s
  loss (queue 512, dropout off, the property mask and the hard negatives
  fixed from a seed) on a batch of 2, on the card (``entry`` :46).
- :func:`dryrun_multichip` starts ``n`` ranks as subprocesses, NCCL on
  ``n`` cards or gloo on the CPU when the caller passes ``device="cpu"``
  (with fewer than ``n`` cards and no ``device="cpu"`` it raises, and it
  never drops to the CPU on its own), and runs every stage of JAX's
  ``dryrun_multichip`` (:70) at its reduced shapes: hidden 144, MLP 576,
  text 4 layers with fusion at 2, property 2 layers, embed 64, a global
  batch of ``n`` rows of 16 tokens, queue ``8 n``; sp and fsdp at 2 + 1
  layers.

  ======  ==========================================  ====================
  stage   runs                                        holds
  ======  ==========================================  ====================
  dp      the data-parallel pretrain step             finite loss, AdamW
                                                      step 1, queue_ptr n
  decode  each rank's rows through beam search (k=2,  the gathered seqs
          stop 4, 8 steps)                            equal rank 0's
                                                      unsharded search
  pp      2 stages, 4 microbatches over the text      the sequential stack
          section (ranks 0 and 1)                     within 2e-4
  ep      n experts over n ranks, top-2               moe_block(n_groups=
                                                      n) within 2e-4,
                                                      finite aux
  tp      the classification fine-tune step on        finite loss
          dp = n/2 x tp = 2
  sp      the tp + sp pretrain step on that mesh      finite loss, step 1
  fsdp    the pretrain step on dp = 2 x fsdp = n/2    finite loss, step 1
  ======  ==========================================  ====================

  Every stage runs: JAX skips stages past a time budget because XLA
  compiles for minutes, and eager PyTorch has nothing to skip.  A failing
  check raises in its rank, which exits non-zero; the call then stops
  every rank and raises.  Rank 0 prints each stage's seconds and the
  summary line ``dryrun_multichip(n) OK in ...s: dp loss=..., ...``.

    python -m spmm_tpu_torch.parallel.dryrun --n 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from spmm_tpu_torch.configs import (
    FinetuneConfig, PretrainConfig, property_config, text_config)
from spmm_tpu_torch.utils.device import DeviceLike, resolve_device

_ROOT = Path(__file__).resolve().parents[2]
# environment a launcher may have set; each rank gets its own
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "PYTHONPATH")
TIMEOUT_S = 900            # a hung rank fails the call, not the caller


def tiny_batch(seed: int, n: int, device: torch.device,
               seq_len: int = 16) -> dict:
    """{"prop" [n, 53], "ids" [n, seq_len] ([CLS] first), "mask"} from a
    generator seeded with ``seed`` (``_tiny_batch``, __graft_entry__.py:
    36-43)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(4, 300, (n, seq_len), generator=gen)
    ids[:, 0] = 2
    return {"prop": torch.randn(n, 53, generator=gen).to(device),
            "ids": ids.to(device),
            "mask": torch.ones(n, seq_len, dtype=torch.int64, device=device)}


def entry(device: DeviceLike = None):
    """``(fn, args)``: ``fn(*args)`` is the full-width pretrain loss of a
    random state (seed 0, queue 512) on a batch of 2 at alpha 0.4, dropout
    off, the property mask drawn from a generator seeded 2 and each row's
    hard negative the other row."""
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, pretrain_loss)

    dev = resolve_device(device)
    pcfg = PretrainConfig(queue_size=512)
    model = init_pretrain_state(0, pcfg, text_config(), property_config(),
                                device=dev)
    batch = tiny_batch(1, 2, dev)
    gen = torch.Generator().manual_seed(2)
    other = torch.tensor([1, 0], device=dev)
    noise = {"mpm_mask": (torch.rand(2, 53, generator=gen)
                          < pcfg.mask_prob).float().to(dev),
             "neg_prop_idx": other, "neg_text_idx": other}

    def fn(model, batch, noise):
        return pretrain_loss(model, batch, 0.4, pcfg, None, noise)[0]

    return fn, (model, batch, noise)


def dryrun_multichip(n: int, device: DeviceLike = None) -> str:
    """Run every stage on ``n`` ranks (subprocesses of this module) and
    return rank 0's summary line; raise if a rank fails or the run
    outlasts ``TIMEOUT_S`` seconds.  ``device=None`` or a CUDA device: NCCL,
    one card a rank; ``"cpu"``: gloo."""
    kind = "cpu" if device is not None and \
        torch.device(device).type == "cpu" else "cuda"
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices, this "
                f"machine has {have}; pass device='cpu' for gloo ranks")
    if n < 2 or n % 2:
        raise ValueError(f"n={n}: the tp stage needs an even number of "
                         "ranks, at least 2")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as work:
        logs = [open(os.path.join(work, f"rank{r}.log"), "w")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "spmm_tpu_torch.parallel.dryrun",
             "--n", str(n), "--device", kind, "--rank", str(r),
             "--store", work],
            env=env, stdout=None if r == 0 else logs[r],
            stderr=logs[r]) for r in range(n)]
        try:
            failed = _wait(procs, TIMEOUT_S)
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for f in logs:
                f.close()
        if failed is not None:
            with open(os.path.join(work, f"rank{failed}.log")) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"dryrun_multichip({n}): rank {failed} "
                               f"failed:\n{tail}")
        with open(os.path.join(work, "summary.txt")) as f:
            return f.read()


def _wait(procs: list, timeout: float) -> Optional[int]:
    """None once every rank exits 0; else the first rank that failed (or
    rank 0 when the deadline passes)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                return r
        if all(code == 0 for code in codes):
            return None
        time.sleep(0.1)
    return 0


# --------------------------------------------------------------------------- #
# one rank
# --------------------------------------------------------------------------- #


def _configs():
    text = dataclasses.replace(text_config(), hidden_size=144,
                               intermediate_size=576, encoder_width=144,
                               num_hidden_layers=4, fusion_layer=2)
    prop = dataclasses.replace(property_config(), hidden_size=144,
                               intermediate_size=576, encoder_width=144,
                               num_hidden_layers=2)
    return (text, prop,
            dataclasses.replace(text, num_hidden_layers=2, fusion_layer=1),
            dataclasses.replace(prop, num_hidden_layers=1))


def _adam_steps(opt) -> int:
    return int(next(iter(opt.state.values()))["step"])


class _Rank:
    """Every stage on this rank; ``run`` returns the summary parts."""

    def __init__(self, n: int, rank: int, dev: torch.device):
        self.n, self.rank, self.dev = n, rank, dev
        self.text, self.prop, self.text_min, self.prop_min = _configs()
        self.pcfg = PretrainConfig(queue_size=8 * n, batch_size=1,
                                   embed_dim=64)
        self.model = None

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def pretrain_step(self, model, sp: bool, seed: int) -> float:
        from spmm_tpu_torch.parallel import mesh, multihost
        from spmm_tpu_torch.training.pretrain import (
            make_pretrain_step, step_generator)

        opt, step = make_pretrain_step(model, self.pcfg, 100, sp=sp)
        batch = tiny_batch(seed, self.n, self.dev)
        rows = torch.as_tensor(multihost.local_rows(
            self.n, mesh.dp_rank(), mesh.dp_size()), device=self.dev)
        m = step(0, {k: v[rows] for k, v in batch.items()},
                 functools.partial(step_generator, seed + 1, 0, self.dev))
        loss = m["loss"].item()
        if not math.isfinite(loss) or _adam_steps(opt) != 1:
            raise RuntimeError(f"pretrain step: loss {loss}, AdamW step "
                               f"{_adam_steps(opt)}")
        return loss

    def dp(self) -> str:
        from spmm_tpu_torch.training.pretrain import init_pretrain_state

        self.model = init_pretrain_state(0, self.pcfg, self.text, self.prop,
                                         device=self.dev)
        loss = self.pretrain_step(self.model, False, 3)
        ptr = int(self.model.queue_ptr)
        if ptr != self.n % self.pcfg.queue_size:
            raise RuntimeError(f"queue_ptr {ptr} after a step of {self.n}")
        return f"dp loss={loss:.4f}"

    def decode(self) -> str:
        from spmm_tpu_torch.inference.decoding import (
            BeamSpec, beam_search_batched)
        from spmm_tpu_torch.parallel import multihost

        gen = torch.Generator().manual_seed(5)
        enc = torch.randn(self.n, 6, self.text.hidden_size,
                          generator=gen).to(self.dev)
        enc_mask = torch.ones(self.n, 6, dtype=torch.int32, device=self.dev)
        spec = BeamSpec(k=2, stop_count=4, max_steps=8)
        decoder = self.model.text_encoder.eval()
        rows = multihost.process_rows(self.n, self.rank, self.n)
        mine = beam_search_batched(decoder, self.text, enc[rows.start:
                                                            rows.stop],
                                   enc_mask[rows.start:rows.stop],
                                   spec)["seqs"].contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.n)]
        dist.all_gather(parts, mine)
        seqs = torch.cat(parts)
        if self.rank == 0:
            whole = beam_search_batched(decoder, self.text, enc, enc_mask,
                                        spec)["seqs"]
            if not torch.equal(seqs, whole):
                raise RuntimeError("the sharded beam search differs from "
                                   "rank 0's unsharded search")
        return f"decode seqs={tuple(seqs.shape)}"

    def pp(self) -> str:
        from spmm_tpu_torch.ops.masks import extend_attention_mask
        from spmm_tpu_torch.parallel import pp

        group = pp.pp_mesh(2)
        if self.rank >= 2:
            return ""
        layers = self.model.text_encoder.bert.encoder.layer[
            :self.text.fusion_layer]
        gen = torch.Generator().manual_seed(13)
        hidden = torch.randn(8, 16, self.text.hidden_size,
                             generator=gen).to(self.dev)
        mask = extend_attention_mask(torch.ones(8, 16, device=self.dev))
        with torch.no_grad():
            out = pp.pipeline_encoder_forward(
                pp.stage_layers(layers, 2, self.rank), self.text, hidden,
                mask, group, 4)
            want = hidden
            for layer in layers:
                want = layer(want, mask)
        err = (out - want).abs().max().item()
        if not err < 2e-4:
            raise RuntimeError(f"pp diverges from the sequential stack: "
                               f"{err}")
        return f"pp max_err={err:.2e}"

    def ep(self) -> str:
        from spmm_tpu_torch.parallel import ep

        block = ep.init_moe_params(14, self.text, self.n, device=self.dev)
        group = ep.ep_mesh(self.n)
        gen = torch.Generator().manual_seed(15)
        hidden = torch.randn(self.n, 16, self.text.hidden_size,
                             generator=gen).to(self.dev)
        rows = ep.ep_rows(self.n, self.rank, self.n)
        with torch.no_grad():
            out, aux = ep.expert_parallel_moe_block(
                ep.expert_shard(block, self.rank, self.n), self.text,
                hidden[rows], group)
            dense, _ = ep.moe_block(block, self.text, hidden,
                                    n_groups=self.n)
        err = (out - dense[rows]).abs().max().reshape(1)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        if not err.item() < 2e-4 or not math.isfinite(
                aux["aux_loss"].item()):
            raise RuntimeError(f"ep diverges from the dense grouped block: "
                               f"{err.item()}, aux {aux['aux_loss'].item()}")
        return f"ep max_err={err.item():.2e}"

    def tp(self) -> str:
        from spmm_tpu_torch.models.downstream import Downstream
        from spmm_tpu_torch.parallel import mesh, multihost
        from spmm_tpu_torch.training.finetune import make_downstream_step

        mesh.set_mesh(self.n // 2, 2, mesh.TP_AXIS)
        model = Downstream.random_init(7, "classification", self.text,
                                       device=self.dev)
        _, step = make_downstream_step(model, FinetuneConfig(), 10)
        gen = torch.Generator().manual_seed(8)
        batch = {"ids": torch.randint(4, 300, (self.n, 16), generator=gen),
                 "mask": torch.ones(self.n, 16, dtype=torch.int64),
                 "target": torch.zeros(self.n, dtype=torch.int64)}
        rows = multihost.process_rows(self.n, mesh.dp_rank(), mesh.dp_size())
        drop = torch.Generator(device=self.dev).manual_seed(
            9 + mesh.dp_rank())
        loss = step(0, {k: v[rows.start:rows.stop].to(self.dev)
                        for k, v in batch.items()}, drop)["loss"].item()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite tp-stage loss: {loss}")
        return f"tp loss={loss:.4f}"

    def sp(self) -> str:
        from spmm_tpu_torch.parallel import mesh
        from spmm_tpu_torch.training.pretrain import init_pretrain_state

        mesh.set_mesh(self.n // 2, 2, mesh.TP_AXIS)
        model = init_pretrain_state(12, self.pcfg, self.text_min,
                                    self.prop_min, device=self.dev)
        return f"sp loss={self.pretrain_step(model, True, 10):.4f}"

    def fsdp(self) -> str:
        from spmm_tpu_torch.parallel import mesh
        from spmm_tpu_torch.training.pretrain import init_pretrain_state

        mesh.set_mesh(2, self.n // 2, mesh.FSDP_AXIS)
        model = init_pretrain_state(12, self.pcfg, self.text_min,
                                    self.prop_min, device=self.dev)
        return f"fsdp loss={self.pretrain_step(model, False, 16):.4f}"

    def run(self) -> list:
        from spmm_tpu_torch.parallel import mesh

        summary = []
        for name in ("dp", "decode", "pp", "ep", "tp", "sp", "fsdp"):
            t0 = time.monotonic()
            part = getattr(self, name)()
            mesh.clear_mesh()
            # every rank ends the stage before the next starts
            dist.barrier()
            dt = time.monotonic() - t0
            self.log(f"dryrun stage {name}: OK in {dt:.1f}s ({part})")
            summary.append(part)
        return summary


def _rank_main(n: int, rank: int, kind: str, store: str) -> None:
    from spmm_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    t0 = time.monotonic()
    dev = multihost.initialize(
        "cpu" if kind == "cpu" else torch.device("cuda", rank),
        init_method=f"file://{store}/store", world_size=n, rank=rank)
    try:
        summary = _Rank(n, rank, dev).run()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        line = (f"dryrun_multichip({n}) OK in {time.monotonic() - t0:.1f}s: "
                + ", ".join(summary))
        print(line, flush=True)
        with open(os.path.join(store, "summary.txt"), "w") as f:
            f.write(line)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Dry run of every parallel "
                                "path on n ranks")
    p.add_argument("--n", type=int, default=4, help="ranks (even)")
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks on the CPU; default NCCL, "
                        "one CUDA device a rank")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.n, args.rank, args.device, args.store)
        return 0
    t0 = time.monotonic()
    dryrun_multichip(args.n, args.device)
    print(f"wall {time.monotonic() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
