#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spmm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Drives the port's paths at the full width of the SPMM model (12-layer
768-wide text BERT with fusion from layer 6, 6-layer property BERT, 53
properties) and of the reaction model (that decoder plus the 6-layer SMILES
encoder) with random weights made from a seed, and holds every kernel
against its plain PyTorch version:

  - PV->SMILES k-beam serving, through kernel 1 (beam_decode_attention);
  - SMILES->PV serving, every attention through kernel 2 (fused_mha);
  - reaction prediction: the reactant encoder through kernel 2, greedy
    (k=1) and k=5 beam decoding through kernel 1, its eval CLI; and the two
    PV->SMILES file CLIs;
  - MoleculeNet fine-tunes and reaction training: train steps on the plain
    attention with dropout, evaluation through kernel 2 (any Lk: past 256
    keys its tiled kernel), and the four training CLIs;
  - SPMM pretraining (four objectives, momentum twins, feature queues) on
    the plain attention, in one process, data-parallel, tensor-parallel
    (with or without sequence parallelism) and fully sharded: it launches
    neither kernel; its checkpoint into both fine-tune CLIs (the evidence
    chain);
  - data-parallel inference over several replicas (``devices=``) and the
    fusion layers' cross-attention maps;
  - pipeline parallelism over the text section (kernel 2 in its forward
    under no_grad), the mixture-of-experts block, the multi-process dry
    run of every parallel path, entry() and the native tokenizer;
  - the port's bench (spmm_tpu_torch/bench.py): each of its workloads
    once, with one timed batch.

Phases, in order; any failure exits non-zero:

  1. device   needs CUDA; prints the card's name and power limit
              (nvidia-smi), turns TF32 off;
  2. build    builds both kernels from the sources in the checkout, one
              nvcc each, started together (with --parent DIR, a checkout of
              another commit, its kernel-2 source too); prints each
              kernel's registers and spills (ptxas) and, from the CUDA
              occupancy API, the blocks per SM and shared memory of its
              launches on the paths (reaction prediction's included: k=1
              and k=5, 96x96, 160x160; past 256 keys every case below, with
              kernel 2's route and cluster size), the largest Lk that
              kernel 2's long kernel (scores resident in shared memory)
              takes before its streaming kernel does (failing unless it is
              1,152 in f32 and 1,408 in bf16), the tensor-core instructions
              of each streaming instantiation (cuobjdump -sass: every bf16
              one has HMMA, no f32 one) and no ptxas spill in any of them;
  3. kernels  beam_decode_attention vs its plain version at the serving
              shapes (m=128, h=12, k=2, D=64, T=104) for f32/bf16/fp8
              caches on random ancestry, plus k=1 and k=5; on the decoder's
              shared-prefix ancestry at positions on both sides of the
              kernel's 32-row tile edges; at T=300, k=8, m=16 in fp32 (its
              largest shared memory); greedy k=1 bf16 at m=128 on the
              greedy mask (one lane, holes where a row emitted token 0);
              k=5 bf16/fp8 at m=32 on random and shared ancestry; the file
              CLIs' m=16 at k=1, 2 (bf16) and 3 (bf16, fp8); the evidence
              run's greedy eval, k=1 bf16 at m=48 and 16, positions to 8
              (timed at m=48, pos 8).  fused_mha
              vs its plain version at the five shapes of
              tests/test_pallas_attention.py, its bf16 case, every launch
              class of SMILES->PV at full width (B=128, h=12, D=64; S in
              16/32/54; L=100) and the reactant encoder's (96x96 and
              160x160, per-row padding), and past 256 keys (Lk 257, 288,
              512, 1000, 1300, 1500, 2000, 4000; padding, causal, none;
              40x1500, 1500x1500 and 1x4000 past both reaches; f32 within
              1e-5, bf16 within 2e-2; each case asserts its route), and a
              fine-tune eval batch of 64 with
              one long molecule (a 505-token text among 63 SMILES, Lk 512,
              the eval's own padding mask).  Times each kernel, its plain
              version and one scaled_dot_product_attention call from the
              replay of a CUDA graph (device time, without the host's
              launch overhead) and computes the bound: kernel 1 at m=128 and
              m=16, greedy k=1 (m=128) and beam k=5 (m=32), kernel 2 at
              every launch class with its launches per batch, at the
              mixed eval batch, and its streaming kernel (past 1,152 keys
              in f32, 1,408 in bf16) at every case past 1,152 keys at B=8,
              in f32 and, past 1,408, in bf16, with its cluster size; and
              the streaming kernel forced (fmha_launch_route) at the long
              kernel's two main-path inputs (B=64 512x512 with 505 live
              keys, B=16 288x288), timed in turns with the long kernel;
  4. exact    captures the mask that inference/decoding.py passes kernel 1
              at the last step of a full-width bf16 batch of 128 (by
              wrapping the name it calls), holds kernel 1 to its plain
              version on it and times it there; then full-width fp32 beam
              search over 8 PVs, once through kernel 1 and once through the
              plain version: identical seqs, as initialised and with the
              [SEP] logit raised (harvest); and fp32 predict_pv of 128
              SMILES through kernel 2 and through the plain attention:
              within 1e-4, 960 launches per batch; full-width fp32 greedy
              over 8 synthetic reactions and k=5 beam search over 4, both
              kernels against both plain versions: identical seqs (and
              steps, n_finished), as initialised and with the [SEP] logit
              raised above every row's least gap (the stop rule runs);
              12 kernel-1 launches per step, 6 kernel-2 launches per batch;
  5. serving  HTTP server -> Pv2SmilesService (bf16, k=2, batch 128):
              raw and partially masked requests, /healthz, a timed full
              batch, one kv_fp8 batch; then HTTP -> Smiles2PvService (fp32,
              batch 128): a wave of 128 requests, an empty one (400),
              /healthz.  Each path is a main path: every kernel's launches
              are counted from 0 over it;
  rxn         reaction prediction, each run a main path: bench.py's bf16
              greedy batch (128 sources of 96 random tokens, 100 steps)
              timed, predict_beam bf16 k=5 over 32 reactions timed,
              cli.rxn_prediction --evaluate at n_beam 1 and 3 over a
              temporary USPTO-480k directory of synthetic reactions
              (result.json written), and cli.pv2smiles_single / _batched
              once each on a synthetic full-size reference .ckpt;
  finetune    MoleculeNet fine-tunes and reaction training at full width
              (text_config()'s 6-layer truncated encoder with the
              classification, 27-label multilabel and regression heads at
              batch 16 / 16 / 8; a copy of the reaction model at batch 16,
              96-token sources, 64-token targets): per model one fp32 step,
              dropout off, on the card against the same step on the CPU
              (loss, every gradient, every parameter after AdamW), then 3
              warm-up and 20 timed steps with dropout on (samples/s, peak
              memory, first and last loss) and one step under
              torch.profiler; the fine-tune evaluate_scores through kernel 2
              against the plain attention (64 SMILES and a 505-token text,
              Lk 512; within 1e-5) and its mol/s; then cli.classification
              (bbbp), cli.classification_multilabel (clintox) and
              cli.regression (esol) for 2 epochs and cli.rxn_prediction
              training for one (a 275-token source among its eval lines,
              Lk 288; checkpoint_best.pt read back), each a main path over
              synthetic files in a temporary directory;
  pretrain    full-width pretraining: one step (batch 8, queue 64, dropout
              off, noise fixed) on the card against the same step on the
              CPU, with the finetune phase's bars and the EMA twins (1e-6),
              the written queue columns (1e-5) and queue_ptr; then batch
              96, queue 36,864, dropout on, in fp32 and in bf16_compute
              (with remat only if fp32 does not fit): 3 warm-up steps, one
              under FlopCounterMode, 20 timed (samples/s, MFU against the
              H100's published fp32 or bf16 peak, peak memory) and one
              under torch.profiler; then cli.pretrain --max_steps 4
              --save_every 2 and a --resume from step_2.pt over a corpus
              of the example SMILES with raw properties from the seed, and
              cli.convert_checkpoint --to_torch of the result, loaded
              strictly into an inference SPMM;
  chain       the evidence chain at smoke size from that resumed
              step_4.pt: load_rxn_checkpoint and the downstream
              load_encoder_from_pretrain put its text encoder into a
              full-width Rxn and a classification Downstream bit for bit;
              then, each a main path, cli.rxn_prediction one epoch over 64
              reactions of scripts/torch_run_finetune_evidence.py's
              make_rxn_data with its greedy eval (batches of 48 and 16, as
              the evidence run's 48) and cli.classification (bbbp) one
              epoch over 64 rows of its make_cls_data: result.json and
              finite losses;
  pretrain_dp data-parallel pretraining through a NCCL process group of
              one (the card's machine has one GPU): at the gate's size the
              data-parallel step equals the one-process step and zero1
              equals replicated, bitwise, and the bf16_moments step on the
              card equals the CPU's at the gate's bars; at batch 96, queue
              36,864, fp32, the data-parallel and one-process steps timed
              in turns over one model, with every all-reduce the
              data-parallel step runs timed by CUDA events; then
              cli.pretrain under torch.distributed.run --standalone
              --nproc_per_node 1 with --zero1 --bf16_moments --async_save
              and a resume from step_2.pt without --async_save (steps 3-4
              equal), the loop's stall at each async save and at the
              blocking save of the same state; neither kernel launches;
  parallel    under a NCCL group of one: the full-width pretrain step
              (batch 96, queue 36,864, fp32, dropout on) under a (1, 1)
              dp x tp mesh with the tp plan, the same with sp, and under a
              (1, 1) dp x fsdp mesh with FSDP2, each from a copy of one
              state against the one-process step at the pretrain gate's
              bars, then timed in turns (one process, tp, sp, fsdp, and
              back) with the memory each keeps and its peak; both kernels
              at a tp rank's heads (h=6 for tp=2, h=3 for tp=4): kernel 2
              at every SMILES->PV launch class, kernel 1 at the serving
              shape, against their plain versions and timed beside their
              bounds; predict_pv under the tp plan through kernel 2 within
              1e-5 of the unsharded model.  Then, as main paths, an fp32
              k=2 beam search of 128 PVs and predict_pv of 128 SMILES over
              devices=[card, card] (two worker processes on the card, a
              copy of the weights each) equal to the unsharded batches
              (seqs exact, values within 1e-5), each shard launching what
              the unsharded batch launches, with the pool's start-up and
              both walls in turns; and
              cross_attention_maps at full width, card against CPU within
              1e-5, every row summing to 1;
  pp_ep       under a NCCL group of one: the pipeline forward of the
              full-width text section (layers [0, 6), 768 wide) on one
              stage, 4 microbatches, over the embeddings of 128 example
              SMILES (L=100) against the sequential section (1e-6), the
              gradient of sum(out^2) (1e-4 of its norm), and under no_grad
              through kernel 2 (1e-5 of the plain run; a main path, 24
              launches), both forwards timed in turns; the GShard MoE block
              (H=768, F=3072, 8 experts, top-2, capacity factor 1.25) over
              [64, 100, 768] in 8 groups, card against CPU (1e-5, aux and
              dropped fraction too), expert-parallel at world 1 against the
              dense block, and its forward and forward + backward timed
              against the dense MLP block's; then
              parallel.dryrun --n 4 --device cpu as a subprocess (four
              gloo ranks, every stage), entry()'s full-width loss on the
              card, and the native tokenizer in use, equal to the Python
              path over 10,000 lines, both in lines/s;
  bench       each workload of spmm_tpu_torch/bench.py once through its
              Bench at full width with one timed batch (or window) each,
              as one main path: PV->SMILES at batch 128 and 60 steps, the
              host pipeline, SMILES->PV, rxn greedy and k=5 beam, the bf16
              pretrain step at batch 96 and the MFU line; every line must
              carry its metric's unit, this card's name and power limit and
              "correct": true (the bench's own kernel-vs-plain checks), and
              both kernels must launch;
  shapes      over phases 5, rxn, finetune, chain and bench, and over the
              bench's headline decodes (bf16 k=2 PV->SMILES batches of 512
              at 60 and 100 steps, run here), every call of a kernel
              wrapper was recorded (KernelCalls); each kernel is held to
              its plain version at every launch shape those paths passed
              it:
              kernel 1 on the masks they passed at steps 0, 1, 33, 100 and
              the last, kernel 2 on the inputs of its first call; and each
              shape is timed as in phase 3 (kernel 1 on the last mask it
              was passed, bf16 caches; kernel 2 on those inputs); with
              --parent, kernel 2 at every input past 256 keys (the eval's
              512x512, the rxn training CLI's 288x288, the mixed batch, the
              streaming kernel's rows of phase 3) timed in turns with the
              other commit's library in its place (parent, this, this,
              parent);
  6. profile  one bf16 PV->SMILES batch, one fp32 SMILES->PV batch and one
              bf16 rxn greedy batch of 128 under torch.profiler: device
              busy share and the kernels that take the device time;
              kernel 2's profiled total beside phase 3's sum of launches x
              ms.

The last two lines are the kernels' JSON record and the device record.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import threading
import time

SEED = 0
SEP_BIAS = 0.7
KERNEL = {"name": "beam_decode_attention", "route": "cuda",
          "source": "spmm_tpu_torch/csrc/beam_decode_attention.cu",
          "replaces": "spmm_tpu/ops/decode_attention.py:57"}
KERNEL2 = {"name": "fused_mha", "route": "cuda",
           "source": "spmm_tpu_torch/csrc/fused_attention.cu",
           "replaces": "spmm_tpu/ops/pallas_attention.py:28"}
REPO = os.path.dirname(os.path.abspath(__file__))
S2P_INPUT = os.path.join(REPO, "examples", "s2p_input.txt")
S2P_LAUNCHES = 6 + 53 * 18      # text layers + 53 steps x (6 + 6 x 2)
RXN_ENC_LAYERS = 6              # kernel-2 launches per reaction batch
RXN_SRC_LEN = 96                # bench.py's rxn greedy source length
# (label, Lq, Lk, mask, cross K/V, launches per batch) of the reactant
# encoder: the 96 bucket, and a source past the 150 bucket (no truncation)
RXN_ENCODER_CLASSES = [("rxn encoder 96x96", 96, 96, "padding", False, 6),
                       ("rxn encoder 160x160", 160, 160, "padding", False,
                        6)]
# (task, outputs, train batch) of the MoleculeNet heads at their CLIs'
# batches, multilabel with SIDER's 27 labels; (batch, source tokens, target
# tokens) of reaction training; warm-up and timed steps of each
FT_TASKS = (("classification", 2, 16), ("multilabel", 27, 16),
            ("regression", 1, 8))
RXN_TRAIN = (16, RXN_SRC_LEN, 64)
FT_WARMUP, FT_TIMED = 3, 20
# pretraining: (batch, queue) of the timed steps, the reference's per-GPU
# sizes; of the card-vs-CPU gate, small so that the CPU step stays short;
# warm-up and timed steps; corpus lines of the CLI run (4 steps an epoch)
PRETRAIN = (96, 36864)
PRETRAIN_GATE = (8, 64)
PT_WARMUP, PT_TIMED = 3, 20
PT_CLI_LINES = 384
# (Lq, Lk, mask) past kernel 2's 256 keys: one key past, a 257-token source
# in a bucket grown by 32, 512 (32-row items of the long kernel), 1000
# (16-row items), 1300 (the long kernel in bf16, the streaming one in f32),
# 1500 and 2000 (past the long kernel in both: the streaming kernel, at a
# small Lq, a many-item Lq = Lk and a decode-shaped query at 4000)
LONG_KEY_CASES = ((37, 257, "padding"), (288, 288, "padding"),
                  (288, 288, "causal"), (64, 512, "padding"),
                  (512, 512, "causal"), (16, 1000, "padding"),
                  (70, 1000, "none"), (40, 1300, "causal"),
                  (33, 2000, "padding"), (40, 1500, "causal"),
                  (1500, 1500, "causal"), (1, 4000, "padding"))
# the first Lk of kernel 2's streaming kernel at D=64, per dtype (the long
# kernel's reach + 1; phase 2 prints the switch points it finds)
STREAM_FROM = {"float32": 1153, "bfloat16": 1409}
# the LONG_KEY_CASES past fused_mha_long_kernel's reach (B=8, h=12, D=64):
# fused_mha_stream_kernel, timed in phase 3 in f32 and, where its route is
# the streaming one, in bf16
STREAM_CASES = tuple(c for c in LONG_KEY_CASES if c[1] >= STREAM_FROM["float32"])
# the long kernel's two main-path inputs (the fine-tune eval's 505-token
# text, B=64 512x512; a 275-token source among short ones in the rxn
# training CLI, B=16 288x288), where phase 3 also times the streaming kernel
# forced (fmha_launch_route) beside it
FORCED_STREAM_CASES = (("eval 505-token text", 64, 512, (505,) * 64),
                       ("rxn 275-token source", 16, 288, (275,) + (96,) * 15))
# pretrain_dp: warm-up steps of each step, then timed steps per turn (turns:
# one process, data parallel, data parallel, one process)
DP_WARMUP, DP_TURN = 1, 5
# parallel: timed steps per turn of each layout (turns: one process, tp,
# tp + sp, fsdp, then back); the heads of a tp rank at tp=2 and tp=4
PAR_TURN = 2
TP_HEADS = (6, 3)
# pp_ep: microbatches of the full-width pipeline and forwards a turn; the
# MoE block's (batch of L=100 rows, experts, groups) and calls a turn;
# lines the tokenizers encode
PP_MICRO, PP_ITERS = 4, 5
MOE, MOE_ITERS = (64, 8, 8), 10
TOKENIZE_LINES = 10000
# bench: spmm_tpu_torch.bench.Setup's counts cut to one timed batch or
# window a workload (the widths stay full)
BENCH_SETUP = dict(decode_steps=(60,), decode_batches=(128,), n_molecules=128,
                   s2p_batches=(128,), s2p_timed=1, rxn_batches=(128,),
                   rxn_timed=1, pretrain_runs=((96, "bf16"),), windows=1,
                   window=2)
# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


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
    """Mean device time of fn(i) over ``iters`` calls, by CUDA events around
    the replay of one CUDA graph that holds all of them: the host's launch
    overhead (tens of microseconds a call through ctypes) does not count,
    only the device's work and the graph's gaps between kernels."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def ptxas_usage(report: str) -> list:
    """(kernel, "registers, spills") for each entry function of an
    ``nvcc -Xptxas -v`` report, names demangled by c++filt where it exists."""
    import re
    import shutil

    entries, name = [], None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            entries.append([name, f"{regs} registers, {spill}"])
            name = None
    if entries and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True).stdout
        for entry, readable in zip(entries, names.splitlines()):
            entry[0] = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                              readable)
    return entries


def occupancy() -> dict:
    """Blocks per SM and dynamic shared-memory bytes of each kernel's
    launches on the paths (and kernel 1's largest case), as the CUDA
    occupancy API gives them for the launch each wrapper makes."""
    import ctypes

    from spmm_tpu_torch.ops import decode_attention, fused_attention

    info = (ctypes.c_int * 4)()
    rows = {}

    def ask(label, query, *args) -> None:
        err = query(*args, info)
        if err:
            fail(f"occupancy of {label}: CUDA error {err}")
        rows[label] = {"blocks_per_sm": info[0], "dynamic_smem_bytes": info[1]}

    def ask2(label, *args) -> None:
        ask(label, lib2.fmha_occupancy, *args)
        rows[label].update(route=fused_attention.ROUTES[info[2]],
                           cluster=info[3])

    lib1, lib2 = decode_attention._library(), fused_attention._library()
    for label, code, k, pos in (("bf16 k=2 pos=103", 1, 2, 103),
                                ("fp8 k=2 pos=103", 2, 2, 103),
                                ("f32 k=8 pos=299", 0, 8, 299),
                                ("bf16 k=1 pos=103 (rxn greedy)", 1, 1, 103),
                                ("bf16 k=5 pos=103 (rxn beam)", 1, 5, 103)):
        ask(f"beam_decode_attention {label}", lib1.bda_occupancy, code, k, 64,
            pos)
    for label, lq, lk, *_ in s2p_launch_classes() + RXN_ENCODER_CLASSES:
        ask2(f"fused_mha f32 {label}", -1, 0, 64, 128, 12, lq, lk)
    for lq, lk, _ in LONG_KEY_CASES:
        for code, name in ((0, "f32"), (1, "bf16")):
            ask2(f"fused_mha {name} B=8 {lq}x{lk} (past 256 keys)", -1, code,
                 64, 8, 12, lq, lk)
    return rows


def long_kernel_reach() -> dict:
    """Where kernel 2's routes past 256 keys switch, per dtype at D=64 (Lq
    64, B=8, h=12), from the route fmha_occupancy reports at Lk = 257 ...
    4096: the last Lk of the long kernel, and, from its shared memory (which
    grows with its resident scores and drops where its items go from 32
    rows to 16), the last Lk with 32-row items.  Fails unless the streaming
    kernel starts at STREAM_FROM."""
    import ctypes

    from spmm_tpu_torch.ops import fused_attention

    lib, info, reach = fused_attention._library(), (ctypes.c_int * 4)(), {}
    for code, name in ((0, "float32"), (1, "bfloat16")):
        prev, top, rows32 = None, None, None
        for lk in range(257, 4097):
            err = lib.fmha_occupancy(-1, code, 64, 8, 12, 64, lk, info)
            if err:
                fail(f"occupancy at Lk {lk}: CUDA error {err}")
            if info[2] != 1:
                continue
            top = lk
            if prev is not None and info[1] < prev and rows32 is None:
                rows32 = lk - 1
            prev = info[1]
        reach[name] = {"rows_32_up_to": rows32, "long_kernel_up_to": top}
        if top is None or top + 1 != STREAM_FROM[name]:
            fail(f"kernel 2's streaming route starts past Lk {top} in {name}, "
                 f"not at {STREAM_FROM[name]}")
    return reach


# --------------------------------------------------------------------------- #
# phase 3: kernel vs plain version
# --------------------------------------------------------------------------- #


def ancestry(dev, m, k, T, pos, kind, g):
    """[m, k, T] ancestor lanes.  "random": a random parent at every
    position; "shared": the decoder's pattern, all beams on one lane up to a
    divergence step, then each on its own lane (rows of the other lanes are
    attended by no beam)."""
    import torch

    if kind == "random":
        return torch.randint(0, k, (m, k, T), generator=g, device=dev)
    lane = torch.randint(0, k, (m, 1, 1), generator=g, device=dev)
    div = torch.randint(0, pos + 1, (m, 1, 1), generator=g, device=dev)
    own = torch.arange(k, device=dev)[None, :, None]
    t = torch.arange(T, device=dev)[None, None, :]
    return torch.where(t < div, lane, own).expand(m, k, T).contiguous()


def kernel_inputs(dev, m, h, k, T, d, L, cache_dtype, pos, seed,
                  kind="random", mask=None):
    """Random cache / q / k_new / v_new and an ancestry mask of ``kind`` at
    every written position (t < pos), or the given ``mask``.  "greedy"
    (k=1) is the mask greedy decoding passes: one lane, and key_valid
    holes where a row emitted token 0."""
    import torch

    from spmm_tpu_torch.ops.decode_attention import ancestry_mask, compute_dtype

    g = torch.Generator(device=dev).manual_seed(seed)
    cdt = compute_dtype(cache_dtype)
    cache = torch.randn((2, L, m, h, k, T, d), generator=g,
                        device=dev).to(cache_dtype)
    q, kn, vn = (torch.randn((m, h, k, d), generator=g, device=dev).to(cdt)
                 for _ in range(3))
    if mask is None:
        valid = (torch.arange(T, device=dev) < pos).expand(m, k, T)
        if kind == "greedy":
            anc = torch.zeros((m, k, T), dtype=torch.int64, device=dev)
            valid = valid & (torch.rand((m, k, T), generator=g,
                                        device=dev) > 0.1)
        else:
            anc = ancestry(dev, m, k, T, pos, kind, g)
        mask = ancestry_mask(anc, valid).contiguous()
    return q, kn, vn, cache, mask


def check_kernel(dev, label, inputs, pos, worst) -> None:
    """Kernel 1 vs its plain version on one case: ctx within 1e-5 (f32) or
    2e-2 (bf16, fp8), the append bitwise, the rest of the cache unchanged."""
    import torch

    from spmm_tpu_torch.ops.decode_attention import (
        beam_decode_attention, beam_decode_attention_reference)

    q, kn, vn, cache, mask = inputs
    cache_dtype, (m, k) = cache.dtype, cache.shape[2:5:2]
    tol = 1e-5 if cache_dtype == torch.float32 else 2e-2
    c_kernel, c_plain = cache.clone(), cache.clone()
    got = beam_decode_attention(q, kn, vn, c_kernel, mask, pos, 1)
    want = beam_decode_attention_reference(q, kn, vn, c_plain, mask, pos, 1)
    sync(dev)
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    row_ok = (torch.equal(bits(c_kernel[0, 1, :, :, :, pos]),
                          bits(kn.to(cache_dtype)))
              and torch.equal(bits(c_kernel[1, 1, :, :, :, pos]),
                              bits(vn.to(cache_dtype))))
    rest_ok = torch.equal(bits(c_kernel), bits(c_plain)) and \
        torch.equal(bits(c_kernel[..., :pos, :]), bits(cache[..., :pos, :]))
    name = str(cache_dtype).replace("torch.", "")
    log(f"  {label:8s} m={m:3d} k={k} T={cache.shape[5]:3d} {name:14s} "
        f"pos={pos:3d}  max|ctx err|={err:.3e} (tol {tol:g})  append="
        f"{'bitwise' if row_ok else 'WRONG'}  rest="
        f"{'unchanged' if rest_ok else 'CHANGED'}")
    if not (ok and row_ok and rest_ok):
        fail(f"kernel disagrees with its plain version ({label}, m={m}, "
             f"k={k}, {name}, pos={pos})")
    worst[name] = max(worst.get(name, 0.0), err)
    return err


def compare_kernel(dev) -> dict:
    """Random ancestry at the serving shapes, the decoder's shared-prefix
    ancestry on both sides of the kernel's 32-row tile edges, the largest
    shared-memory case (T=300, k=8, fp32), and reaction prediction's
    launches: greedy k=1 at m=128 on the greedy mask, beam k=5 at m=32, and
    the file CLIs' batch of 16 at k=1, 2 (bf16) and 3 (bf16, fp8); the
    evidence run's greedy eval (k=1, batches of 48 and 16, products of at
    most 8 tokens: positions up to 8) on the greedy mask."""
    import torch

    h, d, T, L = 12, 64, 104, 2
    f32, bf16, fp8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
    cases = [("random", 128, 2, T, dt, pos) for dt in (f32, bf16, fp8)
             for pos in (1, 33, 103)]
    cases += [("random", 64, 1, T, f32, pos) for pos in (1, 33, 103)]
    cases += [("random", 16, 5, T, f32, pos) for pos in (1, 33, 103)]
    cases += [("greedy", 128, 1, T, bf16, pos) for pos in (1, 33, 100, 103)]
    cases += [("greedy", m, 1, T, bf16, pos) for m in (48, 16)
              for pos in (1, 4, 8)]
    cases += [(kind, 32, 5, T, dt, pos) for kind in ("random", "shared")
              for dt in (bf16, fp8) for pos in (1, 33, 100)]
    cases += [("random", 16, k, T, bf16, pos) for k in (1, 2)
              for pos in (1, 33, 100)]
    cases += [(kind, 16, 3, T, dt, pos) for kind in ("random", "shared")
              for dt in (bf16, fp8) for pos in (1, 33, 100)]
    cases += [("shared", 128, 2, T, dt, pos) for dt in (f32, bf16, fp8)
              for pos in (31, 32, 33, 63, 64, 65, 103)]
    cases += [(kind, 16, 8, 300, f32, pos) for kind in ("random", "shared")
              for pos in (0, 150, 299)]
    worst: dict[str, float] = {}
    for kind, m, k, t_len, cache_dtype, pos in cases:
        inputs = kernel_inputs(dev, m, h, k, t_len, d, L, cache_dtype, pos,
                               seed=pos + 7 * k, kind=kind)
        check_kernel(dev, kind, inputs, pos, worst)
    return worst


class KernelCalls:
    """What the port passes its two kernel wrappers while ``recording``: the
    names it calls them through (inference/decoding's beam_decode_attention,
    ops/attention's fused_mha) are wrapped, and the wrappers launch as
    before, so their launch counts are untouched.  Per launch shape, kernel
    1's mask at layer 0 of the steps at POS_SAMPLES and of the deepest step
    (a later decode of the same shape that stops sooner does not replace
    it), and kernel 2's inputs at its first call."""

    POS_SAMPLES = (0, 1, 33, 100)

    def __init__(self) -> None:
        self.bda: dict = {}     # (m, h, k, T, D, cache dtype) -> {pos: mask}
        self.last: dict = {}    # the same key -> (pos, mask) of the deepest step
        self.mha: dict = {}     # shapes, strides, dtype -> (q, k, v, mask)
        self.paths: dict = {}   # either key -> the path that passed it first

    @contextlib.contextmanager
    def recording(self, path: str):
        import torch

        from spmm_tpu_torch.inference import decoding
        from spmm_tpu_torch.ops import attention

        bda, mha = decoding.beam_decode_attention, attention.fused_mha

        def strided_copy(t):
            return None if t is None else torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)

        def bda_seen(q, k_new, v_new, cache, mask, pos, layer):
            if layer == 0:              # the mask is the same in every layer
                m, h, k, d = q.shape
                key = (m, h, k, cache.shape[5], d, cache.dtype)
                self.paths.setdefault(key, path)
                if pos in self.POS_SAMPLES:
                    self.bda.setdefault(key, {}).setdefault(pos, mask)
                if pos >= self.last.get(key, (-1,))[0]:
                    self.last[key] = (pos, mask)
            return bda(q, k_new, v_new, cache, mask, pos, layer)

        def mha_seen(q, k, v, mask=None):
            key = (tuple(q.shape), tuple(k.shape), q.stride(), k.stride(),
                   v.stride(), q.dtype, None if mask is None else
                   tuple(mask.shape))
            if key not in self.mha:
                self.paths[key] = path
                self.mha[key] = tuple(map(strided_copy, (q, k, v, mask)))
            return mha(q, k, v, mask)

        decoding.beam_decode_attention, attention.fused_mha = bda_seen, mha_seen
        try:
            yield self
        finally:
            decoding.beam_decode_attention, attention.fused_mha = bda, mha

    def kernel1_masks(self) -> dict:
        """key -> {pos: mask} at the sampled steps and the last step."""
        out = {}
        for key, (pos, mask) in self.last.items():
            out[key] = dict(self.bda.get(key, {}))
            out[key][pos] = mask
        return out


def capture_decoder_mask(dev, model, batch: int = 128) -> dict:
    """One full-width bf16 PV->SMILES batch of ``batch``, recorded: the mask
    and pos of kernel 1's last call (the last step)."""
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch, decoder_for

    pv = torch.as_tensor(np.random.default_rng(SEED + 3).normal(
        size=(batch, 53)).astype(np.float32), device=dev)
    calls = KernelCalls()
    with calls.recording("PV->SMILES bf16 batch"):
        res = _beam_batch(model, decoder_for(model, bf16=True), pv,
                          torch.zeros_like(pv), BeamSpec(k=2, stop_count=2))
    sync(dev)
    (pos, mask), = calls.last.values()
    return {"mask": mask, "pos": pos, "steps": res["steps"]}


def time_kernel(dev, m=128, pos=103, mask=None, k=2, kind="random",
                h=12, T=104) -> dict:
    """bf16 at h heads (12, or a tensor-parallel rank's 12 / tp), D=64,
    a cache of T positions (104 for 100 steps, 64 for 60): kernel, plain
    version, one SDPA call, and the bound, on an ancestry mask of ``kind``
    or on the given mask.
    Launches walk the 12 layers, so at m=128, k=2 each reads a layer's
    prefix (81 MB > the 50 MB L2) cold, as the decoder does."""
    import torch
    import torch.nn.functional as F

    from spmm_tpu_torch.ops.decode_attention import (
        beam_decode_attention, beam_decode_attention_reference)
    from spmm_tpu_torch.ops.masks import MASK_VALUE

    d, L = 64, 12
    dt = torch.bfloat16
    q, kn, vn, cache, mask = kernel_inputs(dev, m, h, k, T, d, L, dt, pos,
                                           seed=1, kind=kind, mask=mask)
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
    # (K and V), the mask prefix, q/k_new/v_new, ctx and the appended rows;
    # operations: q.k and p.v over the (beam, key) pairs the mask lets
    # through, plus each beam's self term
    esize = cache.element_size()
    live = mask[..., :pos] > MASK_VALUE
    live_rows = int(live.any(dim=1).sum().item())
    pairs = int(live.sum().item()) + m * k
    small = m * h * k * d * esize
    nbytes = (2 * live_rows * h * d * esize + m * k * k * pos * 4
              + 3 * small + small + 2 * small)
    all_lane_bytes = 2 * m * h * k * pos * d * esize
    flops = 4 * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "m": m, "k": k, "pos": pos, "T": T,
        "bytes": nbytes, "flops": flops, "live_rows": live_rows,
        "all_rows": m * k * pos,
        "bound_ms_all_lanes": all_lane_bytes / HBM_BYTES_PER_S * 1e3,
        "sdpa_vs_kernel_max_abs": sdpa_err,
    }


def mha_inputs(dev, b, h, lq, lk, d, dtype, mask_kind, seed,
               kv_contiguous=False):
    """q (and k/v unless ``kv_contiguous``) as split_heads views of [B, L,
    h*D] projections, as BertAttention passes them; the precomputed cross
    K/V are contiguous [B, h, Lk, D] slices.  Masks from random lengths."""
    import torch

    from spmm_tpu_torch.ops.masks import (
        extend_attention_mask, extend_causal_mask)

    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(n):
        return torch.randn((b, n, h * d), generator=g, device=dev).to(
            dtype).view(b, n, h, d).transpose(1, 2)

    q = heads(lq)
    if kv_contiguous:
        k, v = (torch.randn((b, h, lk, d), generator=g, device=dev).to(dtype)
                for _ in range(2))
    else:
        k, v = heads(lk), heads(lk)
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=dev)
    bin_mask = (torch.arange(lk, device=dev)[None] < lens[:, None]).int()
    if mask_kind == "none":
        return q, k, v, None
    if mask_kind == "padding":
        return q, k, v, extend_attention_mask(bin_mask)
    return q, k, v, extend_causal_mask(bin_mask, q_len=lq, past_len=lk - lq)


def compare_mha(dev) -> dict:
    """fused_mha vs fused_mha_reference: the JAX suite's shapes and every
    launch class of SMILES->PV at full width.  Bars 2e-5 (f32), 3e-2 (bf16)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("pallas-test", 3, 4, lq, lk, f32, kind, False)
             for lq, lk, kind in ((16, 16, "none"), (24, 24, "padding"),
                                  (24, 24, "causal"), (1, 32, "padding"),
                                  (8, 16, "padding"))]
    cases.append(("pallas-test", 2, 2, 16, 16, bf16, "none", False))
    for dt in (f32, bf16):
        cases.append(("text", 128, 12, 100, 100, dt, "padding", False))
        for S in (16, 32, 54):
            cases += [("property", 128, 12, S, S, dt, "padding", False),
                      ("fusion-self", 128, 12, S, S, dt, "causal", False),
                      ("fusion-cross", 128, 12, S, 100, dt, "padding", True)]
    cases += [("rxn-encoder", 128, 12, lq, lk, f32, kind, False)
              for _, lq, lk, kind, *_ in RXN_ENCODER_CLASSES]
    cases += [("long-keys", 8, 12, lq, lk, dt, kind, False)
              for dt in (f32, bf16) for lq, lk, kind in LONG_KEY_CASES]
    worst: dict[str, float] = {}
    for n, (label, b, h, lq, lk, dt, kind, kv_contig) in enumerate(cases):
        q, k, v, mask = mha_inputs(dev, b, h, lq, lk, 64, dt, kind, seed=n,
                                   kv_contiguous=kv_contig)
        if label == "long-keys":
            expect_route(dt, b, h, lq, lk)
        check_mha(dev, label, kind, (q, k, v, mask), worst)
    return worst


def expect_route(dtype, b, h, lq, lk, route: int = -1) -> dict:
    """The launch fmha_occupancy reports for kernel 2 at D=64, failing
    unless its route is the one these key lengths must take: the streaming
    kernel from STREAM_FROM on (or when forced), the long kernel past 256
    keys, else the short one."""
    from spmm_tpu_torch.ops import fused_attention

    name = str(dtype).replace("torch.", "")
    info = fused_attention.launch_info(dtype, 64, b, h, lq, lk, route)
    want = ("stream" if route == fused_attention.STREAM
            or lk >= STREAM_FROM[name] else "long" if lk > 256 else "short")
    if info["route"] != want:
        fail(f"kernel 2 at {name} B={b} {lq}x{lk} takes the {info['route']} "
             f"route, not {want}")
    return info


def check_mha(dev, label, kind, inputs, worst) -> float:
    """fused_mha vs fused_mha_reference on one case: within 2e-5 (f32) or
    3e-2 (bf16), in q's dtype and shape; past 256 keys (the tiled kernel,
    whose tile order changes the sums) within kernel 1's 1e-5 and 2e-2."""
    import torch

    from spmm_tpu_torch.ops.fused_attention import fused_mha, fused_mha_reference

    q, k, v, mask = inputs
    (b, h, lq, d), lk, dt = q.shape, k.shape[2], q.dtype
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    sync(dev)
    tol = {(True, False): 2e-5, (False, False): 3e-2, (True, True): 1e-5,
           (False, True): 2e-2}[dt == torch.float32, lk > 256]
    err = (got.float() - want.float()).abs().max().item()
    name = str(dt).replace("torch.", "")
    log(f"  {label:12s} B={b:3d} h={h:2d} {lq:3d}x{lk:<3d} {kind:7s} "
        f"{name:8s} max|err|={err:.3e} (tol {tol:g})")
    if not (err <= tol and got.dtype == dt
            and tuple(got.shape) == (b, h, lq, d)):
        fail(f"fused_mha disagrees with its plain version ({label}, "
             f"{lq}x{lk}, {kind}, {name})")
    worst[name] = max(worst.get(name, 0.0), err)
    return err


def s2p_launch_classes() -> list:
    """(label, Lq, Lk, mask, cross K/V, launches per batch) of every
    fused_mha launch of one SMILES->PV batch: the 6 text layers once, then
    per step of a segment of S slots 6 property S x S, 6 causal fusion S x S
    and 6 cross S x 100.  Segments 16 / 32 / 54 carry 15 / 16 / 22 steps."""
    classes = [("text 100x100", 100, 100, "padding", False, 6)]
    for s, steps in ((16, 15), (32, 16), (54, 22)):
        classes += [
            (f"property {s}x{s}", s, s, "padding", False, 6 * steps),
            (f"fusion-self {s}x{s} causal", s, s, "causal", False, 6 * steps),
            (f"fusion-cross {s}x100", s, 100, "padding", True, 6 * steps)]
    assert sum(c[-1] for c in classes) == S2P_LAUNCHES
    return classes


def time_mha(dev, classes, h: int = 12) -> list:
    """fp32, B=128, h heads (12, or a tensor-parallel rank's 12 / tp),
    D=64, at each of the given launch classes (label, Lq, Lk, mask, cross
    K/V, launches per batch), on inputs from ``mha_inputs``.  Launches per
    batch beside each, so that sum(launches x ms) can be held against the
    profile."""
    import torch

    rows = []
    for label, lq, lk, kind, kv_contig, launches in classes:
        inputs = mha_inputs(dev, 128, h, lq, lk, 64, torch.float32, kind,
                            seed=lq + lk, kv_contiguous=kv_contig)
        rows.append({"shape": label, "launches_per_batch": launches,
                     **time_mha_on(dev, inputs)})
    return rows


def time_mha_on(dev, inputs) -> dict:
    """Kernel 2, its plain version and one SDPA call with the same float
    mask on the given (q, k, v, mask), and the bound (operations at the
    fp32 rate for fp32 inputs, at the bf16 tensor-core rate for bf16)."""
    import torch
    import torch.nn.functional as F

    from spmm_tpu_torch.ops.fused_attention import fused_mha, fused_mha_reference
    from spmm_tpu_torch.ops.masks import MASK_VALUE

    q, k, v, mask = inputs
    (b, h, lq, d), lk = q.shape, k.shape[2]
    kernel_ms = cuda_ms(lambda i: fused_mha(q, k, v, mask), iters=50)
    plain_ms = cuda_ms(lambda i: fused_mha_reference(q, k, v, mask), iters=20)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters=50)
    sdpa_err = (F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                - fused_mha(q, k, v, mask)).float().abs().max().item()
    # each input read once, the output written once, but only the K/V rows
    # some query attends; operations over the (query, key) pairs the mask
    # lets through
    valid = (torch.ones((b, lq, lk), dtype=torch.bool, device=dev)
             if mask is None else
             (mask > MASK_VALUE / 2).expand(b, 1, lq, lk)[:, 0])
    kv_rows = int(valid.any(dim=1).sum().item())
    nbytes = (q.element_size() * (2 * b * h * lq * d + 2 * h * kv_rows * d)
              + (0 if mask is None else mask.numel() * mask.element_size()))
    flops = 4 * h * d * int(valid.sum().item())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if q.dtype == torch.float32 else
                     BF16_FLOPS) * 1e3
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "sdpa_vs_kernel_max_abs": sdpa_err}


def stream_inputs(dev) -> list:
    """(label, inputs) of each STREAM_CASES row, B=8, h=12, D=64: f32, and
    bf16 where its route is the streaming one."""
    import torch

    rows = []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        for lq, lk, kind in STREAM_CASES:
            if lk >= STREAM_FROM[name]:
                rows.append((f"stream B=8 {lq}x{lk} {kind}",
                             mha_inputs(dev, 8, 12, lq, lk, 64, dt, kind,
                                        seed=lq + lk)))
    return rows


def time_stream(dev) -> list:
    """fused_mha_stream_kernel (kernel 2 past the long kernel's reach) at
    ``stream_inputs``: kernel, plain, SDPA and the bound as ``time_mha_on``
    computes them, with the route and cluster size of the launch.  No main
    path reaches it."""
    rows = []
    for label, inputs in stream_inputs(dev):
        q, k = inputs[0], inputs[1]
        info = expect_route(q.dtype, *q.shape[:3], k.shape[2])
        rows.append({"shape": label, "launches_per_batch": 0,
                     "dtype": str(q.dtype).replace("torch.", ""),
                     "route": info["route"], "cluster": info["cluster"],
                     **time_mha_on(dev, inputs)})
    return rows


def padded_inputs(dev, b, lk, lens, seed):
    """Random f32 split_heads q, k, v (h=12, D=64, Lq = Lk) and the padding
    mask of rows of the given lengths."""
    import torch

    from spmm_tpu_torch.ops.masks import extend_attention_mask

    q, k, v, _ = mha_inputs(dev, b, 12, lk, lk, 64, torch.float32, "none",
                            seed=seed)
    lens = torch.tensor(lens, device=dev)
    mask = (torch.arange(lk, device=dev)[None] < lens[:, None]).int()
    return q, k, v, extend_attention_mask(mask)


def time_forced_stream(dev, worst) -> list:
    """The streaming kernel forced (fmha_launch_route) at the long kernel's
    two main-path inputs, FORCED_STREAM_CASES, held to the plain version
    (1e-5) and timed in turns with the long kernel (long, stream, stream,
    long): whether the cluster split would beat the long kernel there.  The
    wrapper's route does not change."""
    import torch

    from spmm_tpu_torch.ops.fused_attention import (
        STREAM, fused_mha, fused_mha_reference, fused_mha_stream)

    rows = []
    for label, b, lk, lens in FORCED_STREAM_CASES:
        q, k, v, mask = padded_inputs(dev, b, lk, lens, seed=lk + b)
        expect_route(torch.float32, b, 12, lk, lk)
        info = expect_route(torch.float32, b, 12, lk, lk, route=STREAM)
        got = fused_mha_stream(q, k, v, mask)
        err = (got - fused_mha_reference(q, k, v, mask)).abs().max().item()
        if not err <= 1e-5:
            fail(f"the forced streaming kernel disagrees with its plain "
                 f"version at {label} ({err:.3e})")
        worst["float32"] = max(worst.get("float32", 0.0), err)
        turns = [cuda_ms(lambda i: fn(q, k, v, mask), iters=50)
                 for fn in (fused_mha, fused_mha_stream, fused_mha_stream,
                            fused_mha)]
        rows.append({"shape": f"{label} B={b} {lk}x{lk}", "max_abs_err": err,
                     "cluster": info["cluster"],
                     "stream_ms": (turns[1] + turns[2]) / 2,
                     "long_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns})
    return rows


def stream_sass(path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each instantiation of
    fused_mha_stream_kernel, from ``cuobjdump -sass`` of the built library;
    fails unless every bf16 one has some and no f32 one has any."""
    import re
    import shutil

    from spmm_tpu_torch.ops._build import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300)
    if dump.returncode != 0:
        fail(f"cuobjdump -sass: {dump.stderr.strip()[-500:]}")
    counts, name = {}, None
    for line in dump.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            if "fused_mha_stream_kernel" not in name:
                name = None
            else:
                counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    readable = list(counts)                  # mangled names still name the type
    if shutil.which("c++filt"):
        readable = subprocess.run(["c++filt"], input="\n".join(counts),
                                  capture_output=True, text=True).stdout.split("\n")
    out = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", r): n
           for r, n in zip(readable, counts.values())}
    bf16 = {k: n for k, n in out.items() if "bfloat16" in k}
    f32 = {k: n for k, n in out.items() if "bfloat16" not in k}
    if len(bf16) != 4 or len(f32) != 4 or min(bf16.values()) == 0 \
            or max(f32.values()) != 0:
        fail(f"fused_mha_stream_kernel's tensor-core instructions: {out}")
    return out


def mixed_eval_inputs(dev) -> tuple:
    """Kernel 2's inputs in a fine-tune eval batch of 64 with one long
    molecule: a 505-token text and 63 example SMILES, padded as
    evaluate_scores pads them (bucket 512); q, k and v random split_heads
    views (h=12, D=64, fp32), the batch's own padding mask."""
    import numpy as np
    import torch

    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.data.pipeline import batch_supervised
    from spmm_tpu_torch.ops.masks import extend_attention_mask

    texts = ["[CLS]" + long_text(490)] + [
        "[CLS]" + s for s in example_smiles(63)]
    batch = next(batch_supervised(make_tokenizer(), texts, np.zeros(64), 64,
                                  truncation=False, pad_batch=True))
    mask = torch.as_tensor(batch["mask"], device=dev)
    lk = mask.shape[1]
    if lk != 512:
        fail(f"the mixed eval batch has Lk {lk}, not 512")
    q, k, v, _ = mha_inputs(dev, 64, 12, lk, lk, 64, torch.float32, "none",
                            seed=lk)
    return q, k, v, extend_attention_mask(mask)


def parent_library(parent_dir: str):
    """Kernel 2's library built from another checkout's source (the parent
    commit's, unpacked with git archive) with this checkout's flags, and
    bound as fused_attention binds its own."""
    import ctypes
    from pathlib import Path

    from spmm_tpu_torch.ops import _build, fused_attention

    source = Path(parent_dir) / "spmm_tpu_torch" / "csrc" / "fused_attention.cu"
    if not source.exists():
        fail(f"no kernel-2 source at {source}")
    return fused_attention.bind(ctypes.CDLL(str(_build.build(
        "fused_attention", source=source))))


def long_rows_vs_parent(dev, rows: list, parent_lib) -> list:
    """Kernel 2 at each (label, inputs) row, timed in turns with the parent
    library in place of this checkout's (parent, this, this, parent), and
    the parent's result against this kernel's."""
    from spmm_tpu_torch.ops import fused_attention
    from spmm_tpu_torch.ops.fused_attention import fused_mha

    own = fused_attention._library()
    out = []
    try:
        for label, (q, k, v, mask) in rows:
            turns = []
            for lib in (parent_lib, own, own, parent_lib):
                fused_attention._lib = lib
                turns.append(cuda_ms(lambda i: fused_mha(q, k, v, mask),
                                     iters=50))
            fused_attention._lib = parent_lib
            theirs = fused_mha(q, k, v, mask)
            fused_attention._lib = own
            diff = (theirs.float() - fused_mha(q, k, v, mask).float()).abs()
            sync(dev)
            out.append({"shape": label,
                        "dtype": str(q.dtype).replace("torch.", ""),
                        "ms": (turns[1] + turns[2]) / 2,
                        "parent_ms": (turns[0] + turns[3]) / 2,
                        "turns_ms": turns,
                        "parent_vs_kernel_max_abs": diff.max().item()})
    finally:
        fused_attention._lib = own
    return out


# --------------------------------------------------------------------------- #
# phase 4: full-width fp32 exactness, kernel vs plain
# --------------------------------------------------------------------------- #


def launch_counts() -> tuple:
    from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
    from spmm_tpu_torch.ops.fused_attention import fused_mha

    return beam_decode_attention.launches, fused_mha.launches


def reset_launch_counts() -> None:
    from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
    from spmm_tpu_torch.ops.fused_attention import fused_mha

    beam_decode_attention.launches = 0
    fused_mha.launches = 0


def run_counted(dev, fn):
    """(fn(), seconds, kernel-1 launches, kernel-2 launches) of one call."""
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    after = launch_counts()
    return out, time.perf_counter() - t0, after[0] - before[0], \
        after[1] - before[1]


def exactness(dev, model, decoder, n_pv: int = 8, max_steps: int = 100) -> dict:
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec, beam_search_batched
    from spmm_tpu_torch.inference.pv2smiles import encode_pv

    cfg = model.text_cfg
    pv = np.random.default_rng(SEED).normal(size=(n_pv, 53)).astype(np.float32)
    with torch.no_grad():
        enc = encode_pv(model, torch.as_tensor(pv, device=dev), None)
    cross_mask = torch.ones(enc.shape[:2], dtype=torch.int32, device=dev)
    out = {}
    for attention in ("kernel", "plain"):
        spec = BeamSpec(k=2, stop_count=2, max_steps=max_steps,
                        attention=attention)
        out[attention] = run_counted(dev, lambda: beam_search_batched(
            decoder, cfg, enc, cross_mask, spec))
    (rk, tk, lk, _), (rp, tp, lp, _) = out["kernel"], out["plain"]
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


def example_smiles(n: int) -> list:
    """n SMILES of the example file, cycled."""
    with open(S2P_INPUT) as f:
        examples = [line.strip() for line in f if line.strip()]
    return [examples[i % len(examples)] for i in range(n)]


def s2p_batch(n: int = 128) -> tuple:
    """n SMILES (the example file, cycled) tokenized into the service's one
    bucket, L=100."""
    from spmm_tpu_torch.cli._common import make_tokenizer

    smiles = example_smiles(n)
    ids, mask = make_tokenizer().encode_batch(
        ["[CLS]" + s for s in smiles], max_len=100, buckets=(100,))
    return smiles, ids, mask


def exactness_s2p(dev, model) -> tuple[dict, dict]:
    """fp32 predict_pv of 128 SMILES through kernel 2 and through the plain
    attention: within 1e-4 (the golden-gate bar), 960 kernel launches."""
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.smiles2pv import predict_pv

    smiles, ids, mask = s2p_batch()
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = run_counted(dev, lambda: predict_pv(
            model, ids, mask, attention_impl=impl, device=dev))
    (pk, tk, _, lk), (pp, tp, _, lp) = out["kernel"], out["plain"]
    if pk.shape != (128, 53) or pk.dtype != torch.float32:
        fail(f"predict_pv gave {pk.dtype} {tuple(pk.shape)}")
    if not torch.isfinite(pk).all():
        fail("predict_pv gave non-finite predictions")
    err = (pk - pp).abs().max().item()
    if err > 1e-4:
        fail(f"fp32 predictions differ by {err:.3e} > 1e-4 between the "
             f"kernel and the plain attention")
    if lk != S2P_LAUNCHES or lp != 0:
        fail(f"predict_pv launched fused_mha {lk} times (plain run {lp}), "
             f"expected {S2P_LAUNCHES}")
    ref = {s: row for s, row in zip(smiles, pk.cpu().numpy())}
    return {"max_abs_diff": err, "kernel_s": tk, "plain_s": tp,
            "launches": lk, "pred_abs_max": float(np.abs(
                pk.cpu().numpy()).max())}, ref


def rxn_sources(n: int, parts: int = 2) -> list:
    """n synthetic reactant strings: ``parts`` SMILES of the example file
    joined by '.'."""
    smiles = example_smiles(n + parts)
    return [".".join(smiles[i + j] for j in range(parts)) for i in range(n)]


def rxn_batch(dev, n: int) -> tuple:
    """n synthetic reactions tokenized as predict_greedy does."""
    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.inference.rxn import _encode_sources

    return _encode_sources(make_tokenizer(), rxn_sources(n), 150, dev)


def rxn_bench_batch(dev, batch: int, seed: int) -> tuple:
    """bench.py's rxn greedy workload: random ids in [4, 300) of length 96,
    [CLS] first, no padding."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(4, 300, (batch, RXN_SRC_LEN), generator=g, device=dev)
    ids[:, 0] = 2
    return ids, torch.ones_like(ids, dtype=torch.int32)


def check_rxn_launches(what: str, steps: int, n1: int, n2: int,
                       batches: int = 1) -> None:
    """Kernel 1 once per decoder layer per step, kernel 2 once per encoder
    layer per batch."""
    if n1 != 12 * steps or n2 != RXN_ENC_LAYERS * batches:
        fail(f"{what}: {n1} kernel-1 launches for {steps} steps and {n2} "
             f"kernel-2 launches for {batches} batch(es)")


def sep_gap(dev, rxn, ids, mask) -> float:
    """The [SEP] bias that makes every row of an fp32 greedy decode emit
    [SEP]: per row, the least gap over the steps between the top logit and
    [SEP]'s; the largest of those over the rows.  A row decodes as before
    until its first [SEP], so with a bias above its gap it emits [SEP] at
    the latest where the gap was least, and the stop rule ends the run."""
    import torch

    from spmm_tpu_torch.inference import decoding
    from spmm_tpu_torch.inference.rxn import _greedy_batch

    gaps = []
    inner = decoding.decode_step

    def wrapped(*args):
        logits = inner(*args)
        gaps.append(logits.amax(dim=-1) - logits[:, 3])
        return logits

    decoding.decode_step = wrapped
    try:
        _greedy_batch(rxn, rxn.text_encoder, ids, mask, attention="plain")
    finally:
        decoding.decode_step = inner
    return float(torch.stack(gaps).amin(dim=0).amax())


def exactness_rxn(dev, rxn, decoder, n_greedy: int = 8,
                  n_beam: int = 4) -> dict:
    """Full-width fp32 greedy over ``n_greedy`` synthetic reactions and k=5
    beam search (stop_count 25) over ``n_beam``, each through both kernels
    and through both plain versions: identical seqs and steps (greedy),
    seqs and n_finished (beam); 12 kernel-1 launches per step and 6 kernel-2
    launches per batch."""
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.rxn import _beam_batch, _greedy_batch

    ids, mask = rxn_batch(dev, n_greedy)
    out = {}
    for attention in ("kernel", "plain"):
        out[attention] = run_counted(dev, lambda: _greedy_batch(
            rxn, decoder, ids, mask, attention=attention))
    (rk, tk, k1, k2), (rp, tp, p1, p2) = out["kernel"], out["plain"]
    if rk["seqs"].shape != (n_greedy, 104):
        fail(f"greedy seqs shape {tuple(rk['seqs'].shape)}")
    if not (torch.equal(rk["seqs"], rp["seqs"])
            and rk["steps"] == rp["steps"]):
        fail("fp32 greedy seqs / steps differ between the kernel and plain "
             "paths")
    check_rxn_launches("fp32 greedy", rk["steps"], k1, k2)
    if p1 or p2:
        fail(f"the plain greedy run launched kernels ({p1}, {p2})")
    sep = (rk["seqs"] == 3).int()
    first_sep = torch.where(sep.any(dim=1), sep.argmax(dim=1), -1).tolist()
    res = {"greedy_steps": rk["steps"], "first_sep": first_sep,
           "greedy_kernel_s": tk, "greedy_plain_s": tp,
           "greedy_launches": [k1, k2]}

    ids, mask = rxn_batch(dev, n_beam)
    out = {}
    for attention in ("kernel", "plain"):
        spec = BeamSpec(k=5, stop_count=25, attention=attention)
        out[attention] = run_counted(dev, lambda: _beam_batch(
            rxn, decoder, ids, mask, spec))
    (bk, tk, k1, k2), (bp, tp, p1, p2) = out["kernel"], out["plain"]
    if bk["seqs"].shape != (n_beam, 5, 104):
        fail(f"beam seqs shape {tuple(bk['seqs'].shape)}")
    if not (torch.equal(bk["seqs"], bp["seqs"])
            and torch.equal(bk["n_finished"], bp["n_finished"])):
        fail("fp32 k=5 beam seqs / n_finished differ between the kernel and "
             "plain paths")
    check_rxn_launches("fp32 k=5 beam", bk["steps"], k1, k2)
    if p1 or p2:
        fail(f"the plain beam run launched kernels ({p1}, {p2})")
    return dict(res, beam_steps=bk["steps"],
                n_finished=bk["n_finished"].tolist(), beam_kernel_s=tk,
                beam_plain_s=tp, beam_launches=[k1, k2])


# --------------------------------------------------------------------------- #
# phase 5: serving through the HTTP front-end
# --------------------------------------------------------------------------- #


def _post(url: str, payload: dict, path: str = "/pv2smiles"):
    import urllib.request

    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def _concurrent(url: str, payloads: list, path: str = "/pv2smiles",
                key: str = "smiles") -> list:
    results: list = [None] * len(payloads)

    def client(i):
        try:
            results[i] = _post(url, payloads[i], path)
        except Exception as exc:  # noqa: BLE001 — checked below
            results[i] = (None, repr(exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    for i, (status, body) in enumerate(results):
        if status != 200 or key not in body:
            fail(f"request {i}: {status} {body}")
    return [body[key] for _, body in results]


def serving(dev, model, batch: int = 128) -> dict:
    import urllib.request

    import numpy as np

    from spmm_tpu_torch.cli._common import load_stats, make_tokenizer
    from spmm_tpu_torch.cli.serve import make_server
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

        reset_launch_counts()                   # the main path starts here
        t0 = time.perf_counter()
        first = _concurrent(url, wave1)
        t1 = time.perf_counter()
        secs_before = svc.stats["batch_seconds"]
        batches_before = svc.stats["batches"]
        full = _concurrent(url, wave2)
        t2 = time.perf_counter()
        launches, other = launch_counts()       # ... and ends here
        if other:
            fail(f"PV->SMILES serving launched fused_mha {other} times")
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


def serving_s2p(dev, model, ref: dict, batch: int = 128) -> dict:
    """A wave of ``batch`` concurrent POST /smiles2pv through the HTTP
    server -> Smiles2PvService (fp32), plus one empty SMILES (400).  The
    served PVs equal the offline kernel predictions within 1e-4 (normalized
    units)."""
    import urllib.error
    import urllib.request

    import numpy as np

    from spmm_tpu_torch.cli._common import load_stats, make_tokenizer
    from spmm_tpu_torch.cli.serve import make_server
    from spmm_tpu_torch.serving import Smiles2PvService

    tok, stats = make_tokenizer(), load_stats()
    smiles = s2p_batch(batch)[0]
    svc = Smiles2PvService(model, tok, stats=stats, batch_size=batch,
                           max_wait_ms=1500.0, device=dev)
    server = make_server({"smiles2pv": svc}, "127.0.0.1", 0, stats=stats)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_launch_counts()                   # the main path starts here
        t0 = time.perf_counter()
        pvs = _concurrent(url, [{"smiles": s} for s in smiles], "/smiles2pv",
                          "pv")
        wall = time.perf_counter() - t0
        other, launches = launch_counts()       # ... and ends here
        try:
            status = _post(url, {"smiles": ""}, "/smiles2pv")[0]
        except urllib.error.HTTPError as exc:
            status = exc.code
        if status != 400:
            fail(f"an empty SMILES got {status}, not 400")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())["services"]["smiles2pv"]
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    if health["requests"] != batch:
        fail(f"/healthz counts {health['requests']} requests, sent {batch}")
    if launches != S2P_LAUNCHES * health["batches"] or other:
        fail(f"SMILES->PV serving ran {launches} fused_mha launches in "
             f"{health['batches']} batches ({other} of kernel 1)")
    got = stats.normalize(np.asarray(pvs, np.float32))
    want = np.stack([ref[s] for s in smiles])
    if got.shape != (batch, 53) or not np.isfinite(got).all():
        fail(f"served PVs: shape {got.shape}, finite "
             f"{bool(np.isfinite(got).all())}")
    err = float(np.abs(got - want).max())
    if err > 1e-4:
        fail(f"served PVs differ from offline predict_pv by {err:.3e}")
    per_batch_s = health["batch_seconds"] / health["batches"]
    return {"launches": launches, "batches": health["batches"],
            "requests": health["requests"], "wave_wall_s": wall,
            "batch_call_s": per_batch_s, "mol_per_s": batch / per_batch_s,
            "served_vs_offline_max_abs": err, "example": pvs[0][:4]}


# --------------------------------------------------------------------------- #
# phase rxn: reaction prediction and the file CLIs, each a main path
# --------------------------------------------------------------------------- #


def rxn_decoding(dev, rxn, calls, batch: int = 128,
                 beam_batch: int = 32) -> dict:
    """bench.py's rxn greedy workload (bf16, batch 128, sources of 96
    tokens, 100 steps) through ``_greedy_batch``, the call predict_greedy
    makes per batch, and predict_beam (bf16, k=5, stop_count 25) over
    ``beam_batch`` synthetic reactions; each timed after one warm-up call
    of its shapes, with the launches counted from 0 over it and its kernel
    calls recorded in ``calls``."""
    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.inference.rxn import (
        _greedy_batch, decoder_for, predict_beam)

    decoder = decoder_for(rxn, bf16=True)
    _greedy_batch(rxn, decoder, *rxn_bench_batch(dev, batch, SEED + 5))
    ids, mask = rxn_bench_batch(dev, batch, SEED + 4)
    reset_launch_counts()                       # the main path starts here
    with calls.recording("rxn greedy batch"):   # ... and ends here
        res, greedy_s, g1, g2 = run_counted(
            dev, lambda: _greedy_batch(rxn, decoder, ids, mask))
    check_rxn_launches("bf16 greedy batch", res["steps"], g1, g2)
    seqs = res["seqs"]
    if seqs.shape != (batch, 104) or not (seqs[:, 0] == 2).all() \
            or ((seqs < 0) | (seqs >= rxn.decoder_cfg.vocab_size)).any():
        fail(f"greedy batch gave seqs {tuple(seqs.shape)}")

    tok = make_tokenizer()
    sources = rxn_sources(beam_batch)
    predict_beam(rxn, tok, sources, k=5, batch_size=beam_batch, device=dev)
    reset_launch_counts()                       # the main path starts here
    with calls.recording("rxn predict_beam k=5"):   # ... and ends here
        cands, beam_s, b1, b2 = run_counted(dev, lambda: predict_beam(
            rxn, tok, sources, k=5, batch_size=beam_batch, device=dev))
    if b1 <= 0 or b1 % 12 or b2 != RXN_ENC_LAYERS:
        fail(f"predict_beam: {b1} kernel-1 and {b2} kernel-2 launches")
    if len(cands) != beam_batch or not all(
            1 <= len(c) <= 5 and all(isinstance(s, str) for s in c)
            for c in cands):
        fail("predict_beam returned malformed candidates")
    return {"greedy_batch_s": greedy_s, "greedy_mol_per_s": batch / greedy_s,
            "greedy_steps": res["steps"], "greedy_launches": [g1, g2],
            "beam_call_s": beam_s, "beam_mol_per_s": beam_batch / beam_s,
            "beam_steps": b1 // 12, "beam_launches": [b1, b2],
            "beam_example": cands[0][:2]}


def rxn_cli(dev, workdir: str, calls, n_lines: int = 16) -> dict:
    """``cli.rxn_prediction.main(["--evaluate", ...])`` at n_beam 1 and 3
    over a forward-mode USPTO-480k directory of synthetic reactions (two
    example SMILES -> the first), random weights from the seed: the run
    ends and writes result.json.  Kernel calls recorded in ``calls``."""
    from spmm_tpu_torch.cli import rxn_prediction

    data = os.path.join(workdir, "rxn_data")
    os.makedirs(os.path.join(data, "USPTO-480k"))
    lines = [f"{src}\t{src.split('.')[0]}\n" for src in rxn_sources(n_lines)]
    for split in ("valid", "test"):
        with open(os.path.join(data, "USPTO-480k", f"{split}_parsed.txt"),
                  "w") as f:
            f.writelines(lines)
    out = {}
    for n_beam in (1, 3):
        result_dir = os.path.join(workdir, f"rxn_out_{n_beam}")
        reset_launch_counts()                   # the main path starts here
        with calls.recording(f"rxn_prediction n_beam {n_beam}"):
            _, secs, n1, n2 = run_counted(dev, lambda: rxn_prediction.main([
                "--evaluate", "--n_beam", str(n_beam), "--data_dir", data,
                "--output_dir", result_dir, "--seed", str(SEED),
                "--device", dev.type]))           # ... and ends here
        # one batch of each split: 6 encoder launches each
        if n1 <= 0 or n1 % 12 or n2 != 2 * RXN_ENC_LAYERS:
            fail(f"rxn_prediction n_beam {n_beam}: {n1} kernel-1 and {n2} "
                 f"kernel-2 launches")
        with open(os.path.join(result_dir, "result.json")) as f:
            result = json.load(f)
        accs = (result["best_valid_acc"], result["best_test_acc"])
        if result["n_beam"] != n_beam or not all(0 <= a <= 1 for a in accs):
            fail(f"rxn_prediction result.json: {result}")
        out[f"n_beam_{n_beam}"] = {"wall_s": secs, "launches": [n1, n2],
                                   "valid_acc": accs[0], "test_acc": accs[1]}
    return out


def pv2smiles_clis(dev, model, workdir: str, calls,
                   n_lines: int = 16) -> dict:
    """Both PV->SMILES file CLIs once, on a full-size synthetic
    reference-style ``.ckpt`` of ``model``'s random weights:
    pv2smiles_single on examples/p2s_input.csv with --n_generate 16, and
    pv2smiles_batched on a 16-line input with a property cache made from
    the seed.  Kernel 1 only; its calls recorded in ``calls``."""
    import numpy as np
    import torch

    from spmm_tpu_torch.cli import pv2smiles_batched, pv2smiles_single
    from spmm_tpu_torch.cli._common import load_stats

    ckpt = os.path.join(workdir, "synthetic_reference.ckpt")
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, ckpt)
    with open(S2P_INPUT) as f:
        smiles = [line.strip() for line in f if line.strip()]
    inputs = os.path.join(workdir, "pv2smiles_inputs.txt")
    with open(inputs, "w") as f:
        f.writelines(smiles[i % len(smiles)] + "\n" for i in range(n_lines))
    stats = load_stats()
    raw = stats.mean + stats.std * np.random.default_rng(SEED + 6).normal(
        size=(n_lines, 53))
    cache = os.path.join(workdir, "pv2smiles_inputs.npz")
    np.savez(cache, pv=raw.astype(np.float32))
    csv_path = os.path.join(os.path.dirname(S2P_INPUT), "p2s_input.csv")
    runs = {
        "single": (pv2smiles_single, [
            "--checkpoint", ckpt, "--input_csv", csv_path,
            "--n_generate", "16"]),
        "batched": (pv2smiles_batched, [
            "--checkpoint", ckpt, "--input_file", inputs,
            "--property_cache", cache])}
    out = {}
    for name, (cli, argv) in runs.items():
        gen = os.path.join(workdir, f"generated_{name}.txt")
        reset_launch_counts()                   # the main path starts here
        with calls.recording(f"pv2smiles_{name}"):
            _, secs, n1, n2 = run_counted(dev, lambda: cli.main(argv + [
                "--seed", str(SEED), "--output_file", gen,
                "--device", dev.type]))           # ... and ends here
        if n1 <= 0 or n1 % 12 or n2:
            fail(f"pv2smiles_{name}: {n1} kernel-1 and {n2} kernel-2 "
                 f"launches")
        with open(gen) as f:
            n_valid = sum(1 for line in f if line.strip())
        out[name] = {"wall_s": secs, "launches": n1, "valid_written": n_valid}
    os.remove(ckpt)
    return out


# --------------------------------------------------------------------------- #
# phase finetune: MoleculeNet fine-tunes and reaction training
# --------------------------------------------------------------------------- #


def long_text(n_words: int) -> str:
    """An example SMILES and ``n_words`` one-atom words after it, one token
    each: about n_words + 15 tokens.  A single word past 250 characters is
    one [UNK] token (the reference tokenizer's word limit), so only many
    words make a text this long."""
    return example_smiles(1)[0] + " C" * n_words


def ft_batch(dev, task: str, n_out: int, batch: int, seed: int) -> dict:
    """A fine-tune train batch: ``batch`` example SMILES bucket-padded as
    the fine-tune loop's batch_supervised pads them, synthetic targets from
    ``seed``, on the card."""
    import numpy as np
    import torch

    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.data.pipeline import batch_supervised

    rng = np.random.default_rng(seed)
    targets = {"classification": rng.integers(0, 2, batch),
               "multilabel": rng.integers(0, 2, (batch, n_out)).astype(
                   np.float32),
               "regression": rng.normal(size=batch).astype(np.float32)}[task]
    b = next(batch_supervised(make_tokenizer(),
                              ["[CLS]" + s for s in example_smiles(batch)],
                              targets, batch))
    dtype = torch.int64 if task == "classification" else torch.float32
    return {"ids": torch.as_tensor(b["ids"], device=dev),
            "mask": torch.as_tensor(b["mask"], device=dev),
            "target": torch.as_tensor(b["target"], device=dev, dtype=dtype)}


def rxn_train_batch(dev, seed: int) -> dict:
    """A reaction train batch of RXN_TRAIN: random ids in [4, 300), [CLS]
    first, no padding."""
    import torch

    batch, _, tgt_len = RXN_TRAIN
    src_ids, src_mask = rxn_bench_batch(dev, batch, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tgt_ids = torch.randint(4, 300, (batch, tgt_len), generator=g, device=dev)
    tgt_ids[:, 0] = 2
    return {"src_ids": src_ids, "src_mask": src_mask, "tgt_ids": tgt_ids,
            "tgt_mask": torch.ones_like(tgt_ids, dtype=torch.int32)}


def step_gate(dev, model, make_step, batch: dict) -> dict:
    """One step, dropout off, of ``model`` on the card and of its copy on
    the CPU, from the same weights and batch: loss within 1e-5 relative;
    each gradient within 1e-4 of its norm plus a floor of 1e-6 of the
    largest gradient norm (a gradient that is zero in exact arithmetic, as
    the key biases' is, since softmax ignores a shift, is rounding noise on
    both sides); each parameter after the step within 1e-6 plus what the
    first AdamW step makes of its gradient's difference.  That step moves an
    element by lr * g / (|g| + eps), whose slope in g is at most 1 / eps, so
    where |g| is near eps = 1e-8 a rounding difference in g moves the
    parameter by up to lr * |dg| / eps.  TF32 is off: the sums differ only
    in their order."""
    import torch

    from spmm_tpu_torch.configs import FinetuneConfig

    cpu = copy.deepcopy(model).cpu()
    loss = {}
    for where, m, d in (("card", model, dev), ("cpu", cpu, torch.device("cpu"))):
        _, step = make_step(m, FinetuneConfig(), 10)
        res = step(0, {k: v.to(d) for k, v in batch.items()})
        loss[where], lr = res["loss"].item(), res["lr"]
    out = compare_steps(model, cpu, loss, lr)
    del cpu
    return out


def compare_steps(model, cpu, loss: dict, lr: float) -> dict:
    """step_gate's bars on one step that ``model`` took on the card and its
    copy ``cpu`` on the CPU, over the parameters that train."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for the card's fp32 matmuls")
    loss_rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    if not loss_rel <= 1e-5:
        fail(f"card loss {loss['card']} vs CPU {loss['cpu']}")
    pairs = [(name, pc, pd) for (name, pc), pd in
             zip(cpu.named_parameters(), model.parameters())
             if pc.requires_grad]
    floor = 1e-6 * max(pc.grad.norm().item() for _, pc, _ in pairs)
    grad_share, param_err, excess, n_loose = 0.0, 0.0, -1.0, 0
    for name, pc, pd in pairs:
        dg = pd.grad.cpu() - pc.grad
        grad_share = max(grad_share, dg.norm().item()
                         / (1e-4 * pc.grad.norm().item() + floor))
        dp = (pd.detach().cpu() - pc.detach()).abs()
        param_err = max(param_err, dp.max().item())
        n_loose += int((dp > 1e-6).sum().item())
        excess = max(excess, (dp - 1e-6 - lr * dg.abs() / 1e-8).max().item())
        if grad_share > 1 or excess > 0:
            fail(f"card step differs from the CPU step at {name}: gradient "
                 f"at {grad_share:.2f} of its bar, parameter by "
                 f"{dp.max().item():.2e}")
    return {"loss": loss["cpu"], "loss_rel_diff": loss_rel, "lr": lr,
            "grad_worst_share_of_bar": grad_share, "grad_floor": floor,
            "param_max_abs_diff": param_err,
            "params_past_1e-6": n_loose}


def train_throughput(dev, step, batch: dict, n: int) -> dict:
    """FT_WARMUP steps, then FT_TIMED timed between synchronizations, then
    one under torch.profiler; dropout on (a generator from the seed).  No
    kernel launches: training runs the plain attention."""
    import torch

    from spmm_tpu_torch.utils.profiling import device_breakdown

    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = launch_counts()
    losses = [step(i, batch, gen)["loss"] for i in range(FT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(FT_TIMED):
        losses.append(step(FT_WARMUP + i, batch, gen)["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prof = device_breakdown(lambda: step(FT_WARMUP + FT_TIMED, batch, gen),
                            top=6)
    losses = [x.item() for x in losses]
    if launch_counts() != before:
        fail("a train step launched a kernel")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"non-finite train loss: {losses}")
    return {"samples_per_s": FT_TIMED * n / secs,
            "step_ms": 1e3 * secs / FT_TIMED, "batch": n,
            "max_memory_gib": peak / 2 ** 30, "first_loss": losses[0],
            "last_loss": losses[-1], "profile": prof}


def finetune_training(dev, rxn) -> dict:
    """Per model (the three MoleculeNet heads on text_config()'s 6-layer
    truncated encoder, and a copy of the full-width reaction model): the
    card-vs-CPU step gate, then the throughput run with dropout on."""
    from spmm_tpu_torch.configs import FinetuneConfig
    from spmm_tpu_torch.models.downstream import Downstream
    from spmm_tpu_torch.training.finetune import (
        make_downstream_step, make_rxn_step)

    out = {}
    for n, (task, n_out, batch) in enumerate(FT_TASKS):
        model = Downstream.random_init(SEED, task, n_output=n_out, device=dev)
        b = ft_batch(dev, task, n_out, batch, SEED + n)
        gate = step_gate(dev, model, make_downstream_step, b)
        _, step = make_downstream_step(model, FinetuneConfig(), 100)
        out[task] = dict(train_throughput(dev, step, b, batch), gate=gate)
        del model, step
    model = copy.deepcopy(rxn)
    b = rxn_train_batch(dev, SEED + 8)
    gate = step_gate(dev, model, make_rxn_step, b)
    _, step = make_rxn_step(model, FinetuneConfig(), 100)
    out["rxn"] = dict(train_throughput(dev, step, b, RXN_TRAIN[0]), gate=gate)
    return out


def pretrain_batch(dev, n: int, seed: int) -> tuple[dict, dict]:
    """A pretrain batch and fixed noise: n - 1 example SMILES and one text
    cut at 100 tokens (the 100 bucket, as a batch of 96 real molecules
    reaches), normalized properties and a property mask from ``seed``, hard
    negatives at the next and previous rows."""
    import numpy as np
    import torch

    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.tokenizer import default_buckets

    texts = ["[CLS]" + t for t in example_smiles(n - 1) + [long_text(90)]]
    ids, mask = make_tokenizer().encode_batch(texts, max_len=100,
                                              buckets=default_buckets(100))
    if ids.shape[1] != 100:
        fail(f"pretrain batch padded to {ids.shape[1]}, not 100")
    rng = np.random.default_rng(seed)
    rows = np.arange(n)
    batch = {"prop": rng.normal(size=(n, 53)).astype(np.float32),
             "ids": ids, "mask": mask}
    noise = {"mpm_mask": (rng.random((n, 53)) < 0.5).astype(np.float32),
             "neg_prop_idx": (rows + 1) % n, "neg_text_idx": (rows - 1) % n}
    return ({k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
            {k: torch.as_tensor(v, device=dev) for k, v in noise.items()})


def pretrain_gate(dev, bf16_moments: bool = False) -> dict:
    """One full-width pretrain step at PRETRAIN_GATE's batch and queue,
    dropout off and the noise fixed, on the card and on the CPU from the
    same state (global step 12 of 10 an epoch: alpha 0.4 and the cosine
    lr): step_gate's bars on the loss, the clipped gradients and the
    parameters (``temp`` among them), and the EMA twins within 1e-6, the
    written queue columns within 1e-5, ``queue_ptr`` equal.  Under a
    process group the card's step is the data-parallel one; the CPU's is
    the one-process step."""
    import torch

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import (
        EMA_KEYS, init_pretrain_state, make_pretrain_step)

    n, queue = PRETRAIN_GATE
    pcfg = PretrainConfig(queue_size=queue, bf16_moments=bf16_moments)
    cpu = init_pretrain_state(SEED, pcfg, device="cpu")
    model = copy.deepcopy(cpu).to(dev)
    batch, noise = pretrain_batch(torch.device("cpu"), n, SEED + 20)
    loss = {}
    for where, m, d in (("card", model, dev),
                        ("cpu", cpu, torch.device("cpu"))):
        _, step = make_pretrain_step(
            m, pcfg, 10, data_parallel=False if where == "cpu" else None)
        res = step(12, {k: v.to(d) for k, v in batch.items()}, None,
                   {k: v.to(d) for k, v in noise.items()})
        if res["skipped"]:
            fail(f"the gate's pretrain step on the {where} was skipped")
        loss[where], lr = res["loss"].item(), res["lr"]
    out = compare_steps(model, cpu, loss, lr)
    got, want = model.state_dict(), cpu.state_dict()
    twin_err = max((got[k].cpu() - v).abs().max().item()
                   for k, v in want.items()
                   if k.split(".", 1)[0] in {f"{e}_m" for e in EMA_KEYS})
    queue_err = max((got[k][:, :n].cpu() - want[k][:, :n]).abs().max().item()
                    for k in ("prop_queue", "text_queue"))
    if not twin_err <= 1e-6 or not queue_err <= 1e-5 or \
            got["queue_ptr"].tolist() != [n] or \
            want["queue_ptr"].tolist() != [n]:
        fail(f"pretrain gate: twins {twin_err:.2e} (bar 1e-6), queues "
             f"{queue_err:.2e} (bar 1e-5), ptr {got['queue_ptr'].tolist()} "
             f"vs {want['queue_ptr'].tolist()}")
    del cpu, model
    return dict(out, twin_max_abs_diff=twin_err,
                queue_max_abs_diff=queue_err,
                temp=want["temp"].item())


def pretrain_timing(dev, bf16: bool, remat: bool = False) -> dict:
    """PRETRAIN's batch and queue at full width, dropout on (a generator
    per step from the seed): PT_WARMUP steps, one step under
    FlopCounterMode, PT_TIMED steps timed between synchronizations (peak
    memory over them), then one step under torch.profiler.  If fp32 does
    not fit without remat, it runs again with remat and says so."""
    import torch

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, make_pretrain_step, step_generator)
    from spmm_tpu_torch.utils.profiling import (
        H100_PEAK_FLOPS, count_flops, device_breakdown)

    n, queue = PRETRAIN
    pcfg = PretrainConfig(queue_size=queue, bf16_compute=bf16, remat=remat)
    model = init_pretrain_state(SEED, pcfg, device=dev)
    _, step = make_pretrain_step(model, pcfg, 1000)
    batch, _ = pretrain_batch(dev, n, SEED + 21)

    def run(i):
        return step(i, batch, step_generator(SEED, i, dev))

    before = launch_counts()
    try:
        losses = [run(i)["loss"] for i in range(PT_WARMUP)]
        _, flops = count_flops(lambda: run(PT_WARMUP))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(PT_TIMED):
            losses.append(run(PT_WARMUP + 1 + i)["loss"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError:
        if remat:
            raise
        del model, step, batch
        torch.cuda.empty_cache()
        log(f"  pretrain {'bf16' if bf16 else 'fp32'} at batch {n} does "
            f"not fit without remat: running it with --remat")
        return pretrain_timing(dev, bf16, remat=True)
    peak_mem = torch.cuda.max_memory_allocated()
    prof = device_breakdown(lambda: run(PT_WARMUP + 1 + PT_TIMED), top=8)
    losses = [x.item() for x in losses]
    if launch_counts() != before:
        fail("a pretrain step launched a kernel")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"non-finite pretrain loss: {losses}")
    peak = H100_PEAK_FLOPS["bf16" if bf16 else "fp32"]
    step_s = secs / PT_TIMED
    del model, step, batch
    torch.cuda.empty_cache()
    return {"dtype": "bf16" if bf16 else "fp32", "remat": remat, "batch": n,
            "queue": queue, "samples_per_s": n / step_s,
            "step_ms": 1e3 * step_s, "flops_per_step": flops,
            "peak_flops": peak, "mfu": flops / step_s / peak,
            "max_memory_gib": peak_mem / 2 ** 30, "first_loss": losses[0],
            "last_loss": losses[-1], "profile": prof}


def _run_cli(args: list, what: str) -> tuple[str, float]:
    """``python -m`` one of the port's CLIs from the checkout, on the card;
    (its stdout, seconds).  A failure shows its output's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=900, cwd=REPO)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def _metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def pretrain_corpus(workdir: str) -> tuple[str, str]:
    """The example SMILES cycled to PT_CLI_LINES lines and raw properties
    from the seed (the reference's mean and std): (corpus, property
    cache)."""
    import numpy as np

    from spmm_tpu_torch.chem.normalize import PropertyStats

    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w") as f:
        f.writelines(s + "\n" for s in example_smiles(PT_CLI_LINES))
    stats = PropertyStats.load()
    pv = stats.mean + stats.std * np.random.default_rng(SEED).normal(
        size=(PT_CLI_LINES, 53))
    cache = os.path.join(workdir, "corpus.pv.npz")
    np.savez(cache, pv=pv.astype(np.float32))
    return corpus, cache


def pretrain_cli(dev, workdir: str) -> dict:
    """cli.pretrain at full width on the card over a corpus of the example
    SMILES cycled to PT_CLI_LINES lines and raw properties from the seed
    (the reference's mean and std): --max_steps 4 --save_every 2, then
    --resume from step_2.pt to step 4 in another directory; then
    cli.convert_checkpoint --to_torch of the resumed step_4.pt, loaded
    strictly into an inference SPMM."""
    import numpy as np
    import torch

    from spmm_tpu_torch.checkpoint.convert import load_spmm_checkpoint
    from spmm_tpu_torch.models.spmm import SPMM

    corpus, cache = pretrain_corpus(workdir)
    first, second = (os.path.join(workdir, d) for d in ("first", "second"))
    common = ["spmm_tpu_torch.cli.pretrain", "--data_path", corpus,
              "--property_cache", cache, "--max_steps", "4",
              "--save_every", "2", "--seed", str(SEED)]
    out1, s1 = _run_cli(common + ["--output_dir", first], "cli.pretrain")
    out2, s2 = _run_cli(common + ["--output_dir", second, "--resume",
                                  os.path.join(first, "step_2.pt")],
                        "cli.pretrain --resume")
    run1 = _metrics(os.path.join(first, "metrics.jsonl"))
    run2 = _metrics(os.path.join(second, "metrics.jsonl"))
    names = sorted(os.listdir(first)), sorted(os.listdir(second))
    want = ["metrics.jsonl", "run_meta.json", "step_2.pt", "step_4.pt"]
    if names != (want, ["metrics.jsonl", "run_meta.json", "step_4.pt"]) or \
            [r["step"] for r in run1] != [1, 2, 3, 4] or \
            [r["step"] for r in run2] != [3, 4] or \
            "resumed at step 2" not in out2 or \
            not all(np.isfinite(r["loss"]) for r in run1 + run2):
        fail(f"cli.pretrain: files {names}, steps {[r['step'] for r in run1]}"
             f" and {[r['step'] for r in run2]}")
    resume_diff = max(abs(a["loss"] - b["loss"])
                      for a, b in zip(run1[2:], run2))
    ckpt = os.path.join(second, "step_4.pt")
    ckpt_gib = os.path.getsize(ckpt) / 2 ** 30
    for name in ("step_2.pt", "step_4.pt"):
        os.remove(os.path.join(first, name))
    exported = os.path.join(workdir, "exported.ckpt")
    _, s3 = _run_cli(["spmm_tpu_torch.cli.convert_checkpoint", "--torch_ckpt",
                      ckpt, "--out", exported, "--to_torch"],
                     "cli.convert_checkpoint --to_torch")
    saved = torch.load(ckpt, map_location="cpu",
                       weights_only=True)["state_dict"]
    spmm = load_spmm_checkpoint(SPMM.random_init(SEED + 1, device=dev),
                                exported)
    if not all(torch.equal(v.cpu(), saved[k])
               for k, v in spmm.state_dict().items()):
        fail("the exported checkpoint did not load as saved")
    mfu_line = [ln for ln in out1.splitlines() if ln.startswith("MFU")]
    parts = ("loss", "loss_mlm", "loss_mpm", "loss_ita", "loss_itm")
    return {"wall_s": [s1, s2, s3],
            "losses": [{k: r[k] for k in parts} for r in run1],
            "resumed_losses": [r["loss"] for r in run2],
            "resume_loss_max_abs_diff": resume_diff,
            "checkpoint_gib": ckpt_gib, "mfu_line": mfu_line[:1]}


def evidence_script():
    """scripts/torch_run_finetune_evidence.py, loaded by path (its data
    generators)."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "torch_run_finetune_evidence.py")
    spec = importlib.util.spec_from_file_location(
        "torch_run_finetune_evidence", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chain_loads(dev, ckpt: str) -> dict:
    """``load_rxn_checkpoint`` and the downstream ``load_encoder_from_pretrain``
    put the text encoder of the port's own pretrain checkpoint into a
    full-width ``Rxn`` and a classification ``Downstream`` on the card:
    every transferred tensor equal, bit for bit, to the saved one."""
    import torch

    from spmm_tpu_torch.checkpoint.convert import load_reference_checkpoint
    from spmm_tpu_torch.cli.rxn_prediction import load_rxn_checkpoint
    from spmm_tpu_torch.models.downstream import (
        Downstream, load_encoder_from_pretrain)
    from spmm_tpu_torch.models.rxn import Rxn

    saved = torch.load(ckpt, map_location="cpu",
                       weights_only=True)["state_dict"]
    # the reactant encoder: text_encoder.* without the upper layers; its
    # tied LM head is the word table, the head's bias cls.predictions.bias
    tied = {"cls.predictions.decoder.weight":
            "text_encoder.bert.embeddings.word_embeddings.weight",
            "cls.predictions.decoder.bias": "text_encoder.cls.predictions.bias"}
    rxn = load_rxn_checkpoint(Rxn.random_init(SEED + 2, device=dev), ckpt)
    pairs = [(v, saved[tied.get(k, "text_encoder." + k)])
             for k, v in rxn.text_encoder2.state_dict().items()]
    n_rxn = len(pairs)
    del rxn
    ds = load_encoder_from_pretrain(
        Downstream.random_init(SEED + 2, "classification", device=dev),
        load_reference_checkpoint(ckpt))
    pairs += [(v, saved["text_encoder.bert." + k])
              for k, v in ds.text_encoder.bert.state_dict().items()]
    del ds
    unequal = sum(not (got.dtype == want.dtype and torch.equal(
        bits(got.cpu()), bits(want))) for got, want in pairs)
    if unequal:
        fail(f"chain: {unequal} of {len(pairs)} encoder tensors differ from "
             "the pretrain checkpoint's")
    return {"rxn_encoder_tensors": n_rxn,
            "downstream_encoder_tensors": len(pairs) - n_rxn}


def chain_phase(dev, workdir: str, calls) -> dict:
    """The evidence chain at smoke size, from the port's own pretrain
    checkpoint: the resumed step_4.pt that ``pretrain_cli`` leaves in
    ``workdir``.  Bitwise encoder loads (``chain_loads``), then, each a
    main path with its kernel calls recorded, cli.rxn_prediction (one
    epoch over 64 reactions of the evidence script's ``make_rxn_data``,
    greedy eval of 64 per split at --batch_size_eval 48: batches of 48 and
    16) and cli.classification --name bbbp (one epoch over 64 rows of
    ``make_cls_data``, eval of 64 per split): both end with result.json and
    finite losses."""
    import numpy as np

    from spmm_tpu_torch.cli import classification, rxn_prediction

    t_start = time.perf_counter()
    ckpt = os.path.join(workdir, "second", "step_4.pt")
    out = {"loads": chain_loads(dev, ckpt)}
    ev = evidence_script()
    rxn_data = ev.make_rxn_data(os.path.join(workdir, "chain_rxn"),
                                n_train=64, n_eval=64)
    cls_data = ev.make_cls_data(os.path.join(workdir, "chain_cls"),
                                n_train=64, n_eval=64)
    runs = (
        ("rxn_prediction", rxn_prediction, [
            "--mode", "forward", "--data_dir", rxn_data, "--epoch", "1",
            "--n_beam", "1", "--batch_size", "16", "--batch_size_eval", "48",
            "--seed", str(SEED)],
         # per split a greedy batch of 48 and one of 16: 6 launches each
         lambda n1, n2: n1 > 0 and n1 % 12 == 0 and n2 == 4 * RXN_ENC_LAYERS),
        ("classification", classification, [
            "--name", "bbbp", "--data_dir", cls_data, "--epoch", "1",
            "--batch_size", "16"],
         # one eval batch of 64 per split
         lambda n1, n2: n1 == 0 and n2 == 2 * 6),
    )
    for name, cli, argv, launches_ok in runs:
        result_dir = os.path.join(workdir, f"chain_{name}_out")
        reset_launch_counts()                   # the main path starts here
        with calls.recording(f"chain: cli.{name}"):
            _, secs, n1, n2 = run_counted(dev, lambda: cli.main(
                ["--checkpoint", ckpt, "--output_dir", result_dir,
                 "--device", dev.type] + argv))   # ... and ends here
        with open(os.path.join(result_dir, "result.json")) as f:
            result = json.load(f)
        losses = [r["loss"] for r in _metrics(
            os.path.join(result_dir, "metrics.jsonl"))]
        if not launches_ok(n1, n2) or result["steps"] != 4 or \
                len(losses) != 4 or not np.all(np.isfinite(losses)):
            fail(f"chain: cli.{name} launches ({n1}, {n2}), losses {losses}, "
                 f"result {result}")
        out[name] = {"wall_s": secs, "launches": [n1, n2], "losses": losses,
                     **{k: result[k] for k in result
                        if k.startswith("best_")}}
    out["wall_s"] = time.perf_counter() - t_start
    return out


def dp_gate(dev) -> dict:
    """pretrain_dp (a), under the NCCL group of one: at PRETRAIN_GATE's
    batch and queue, dropout off, the noise fixed, global step 12, one step
    from one full-width state by the one-process step, the data-parallel
    step (replicated) and the data-parallel step with zero1, each on its
    own copy: replicated equals one-process, and zero1 equals replicated,
    bitwise (parameters, twins, queues, queue_ptr, the loss); between
    steps zero1 keeps only its share of the twins (at world 1 all of them,
    in one flat buffer, the twins themselves released).  Then the
    bf16_moments step on the card against the CPU's at the pretrain gate's
    bars (``pretrain_gate``)."""
    import torch

    from spmm_tpu_torch.checkpoint.io import model_state
    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, make_pretrain_step)

    n, queue = PRETRAIN_GATE
    batch, noise = pretrain_batch(dev, n, SEED + 20)
    start = init_pretrain_state(SEED, PretrainConfig(queue_size=queue),
                                device=dev)
    models, losses = {}, {}
    for name, zero1, dp in (("one_process", False, False),
                            ("replicated", False, None),
                            ("zero1", True, None)):
        models[name] = copy.deepcopy(start)
        _, step = make_pretrain_step(
            models[name], PretrainConfig(queue_size=queue, zero1=zero1), 10,
            data_parallel=dp)
        res = step(12, batch, None, noise)
        if res["skipped"]:
            fail(f"the {name} step of the dp gate was skipped")
        losses[name] = res["loss"].item()
    shards = models["zero1"].twin_shards
    twins = shards.resident_elements()
    if shards.gathered or twins != shards.padded:
        fail(f"zero1 keeps {twins} twin elements between steps, not its "
             f"share of {shards.padded}")
    for name, want in (("replicated", "one_process"),
                       ("zero1", "replicated")):
        got, ref = (model_state(models[k]) for k in (name, want))
        differ = [k for k, v in ref.items() if not torch.equal(got[k], v)]
        if differ or losses[name] != losses[want]:
            fail(f"the {name} step differs from the {want} step: loss "
                 f"{losses[name]} vs {losses[want]}, {len(differ)} tensors "
                 f"differ, e.g. {differ[:3]}")
    del models, start
    torch.cuda.empty_cache()
    return {"losses": losses, "bitwise_equal": True,
            "zero1_twin_elements_between_steps": twins,
            "bf16_moments_gate": pretrain_gate(dev, bf16_moments=True)}


def dp_timing(dev) -> dict:
    """pretrain_dp (b): PRETRAIN's batch and queue, fp32, dropout on (a
    generator per chunk from the seed), one full-width model and two steps
    over it, the one-process step and the data-parallel step (NCCL, world
    1): DP_WARMUP warm-up steps each, then DP_TURN timed steps a turn in
    turns (one process, data parallel, data parallel, one process).  During
    the data-parallel turns every torch.distributed.all_reduce the step
    calls is timed by CUDA events: the gradients' (one flat buffer of the
    online parameters) and the loss's."""
    import functools

    import torch
    import torch.distributed as dist

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, make_pretrain_step, step_generator)

    n, queue = PRETRAIN
    pcfg = PretrainConfig(queue_size=queue)
    model = init_pretrain_state(SEED, pcfg, device=dev)
    n_grads = sum(p.numel() for p in model.online_parameters())
    steps = {"one_process": make_pretrain_step(model, pcfg, 1000,
                                               data_parallel=False)[1],
             "data_parallel": make_pretrain_step(model, pcfg, 1000)[1]}
    batch, _ = pretrain_batch(dev, n, SEED + 21)
    count = [0]
    losses = []

    def run(name):
        i = count[0]
        count[0] += 1
        losses.append(steps[name](i, batch, functools.partial(
            step_generator, SEED, i, dev))["loss"])

    reduces = []
    real = dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(tensor, *args, **kwargs)
        end.record()
        reduces.append((tensor.numel(), start, end))
        return out

    before = launch_counts()
    for name in steps:
        for _ in range(DP_WARMUP):
            run(name)
    turns = {name: [] for name in steps}
    for name in ("one_process", "data_parallel", "data_parallel",
                 "one_process"):
        torch.cuda.synchronize()
        if name == "data_parallel":
            dist.all_reduce = timed_all_reduce
        try:
            t0 = time.perf_counter()
            for _ in range(DP_TURN):
                run(name)
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) / DP_TURN)
        finally:
            dist.all_reduce = real
    losses = [x.item() for x in losses]
    if launch_counts() != before:
        fail("a data-parallel pretrain step launched a kernel")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"non-finite pretrain loss: {losses}")
    grads_ms = [s.elapsed_time(e) for k, s, e in reduces if k == n_grads]
    other_ms = [s.elapsed_time(e) for k, s, e in reduces if k != n_grads]
    if len(grads_ms) != 2 * DP_TURN:
        fail(f"{len(grads_ms)} gradient all-reduces of {n_grads} elements "
             f"in {2 * DP_TURN} data-parallel steps")
    step_ms = {name: 1e3 * sum(t) / len(t) for name, t in turns.items()}
    del model, steps, batch
    torch.cuda.empty_cache()
    return {"batch": n, "queue": queue, "step_ms": step_ms,
            "turns_ms": {k: [1e3 * t for t in v] for k, v in turns.items()},
            "samples_per_s": {k: 1e3 * n / v for k, v in step_ms.items()},
            "dp_over_one_process": step_ms["data_parallel"]
            / step_ms["one_process"],
            "grad_elements": n_grads,
            "grad_all_reduce_ms": grads_ms,
            "loss_all_reduce_ms": other_ms,
            "first_loss": losses[0], "last_loss": losses[-1]}


def dp_cli(dev, workdir: str) -> dict:
    """pretrain_dp (c): cli.pretrain under torch.distributed.run
    --standalone --nproc_per_node 1 with --zero1 --bf16_moments
    --async_save --max_steps 4 --save_every 2 over pretrain_corpus, then
    the same without --async_save from step_2.pt to step 4: steps 3-4's
    losses equal the first run's, bitwise, so both runs save the same
    state at step 4.  The CLI prints how long its loop stood still at each
    save: the first run's two async saves, the resume's blocking one."""
    corpus, cache = pretrain_corpus(workdir)
    first, second = (os.path.join(workdir, d) for d in ("dp_first",
                                                        "dp_second"))
    common = ["torch.distributed.run", "--standalone", "--nproc_per_node",
              "1", "-m", "spmm_tpu_torch.cli.pretrain", "--zero1",
              "--bf16_moments", "--max_steps", "4", "--save_every", "2",
              "--data_path", corpus, "--property_cache", cache, "--seed",
              str(SEED)]
    out1, s1 = _run_cli(common + ["--async_save", "--output_dir", first],
                        "torch.distributed.run cli.pretrain")
    out2, s2 = _run_cli(common + ["--output_dir", second, "--resume",
                                  os.path.join(first, "step_2.pt")],
                        "torch.distributed.run cli.pretrain --resume")
    run1 = _metrics(os.path.join(first, "metrics.jsonl"))
    run2 = _metrics(os.path.join(second, "metrics.jsonl"))
    stalls = [[float(ln.split("stood still ")[1].split(" s")[0])
               for ln in out.splitlines() if ln.startswith("saved step_")]
              for out in (out1, out2)]
    waits = [float(ln.split("(")[1].split(" s")[0])
             for ln in out1.splitlines() if ln.startswith("saved step_")]
    setup = [float(ln.split("after ")[1].split(" s")[0])
             for ln in (out1 + out2).splitlines()
             if ln.startswith("state ready after")]
    with open(os.path.join(first, "run_meta.json")) as f:
        meta = json.load(f)
    if [r["step"] for r in run1] != [1, 2, 3, 4] or \
            [r["step"] for r in run2] != [3, 4] or \
            "resumed at step 2" not in out2 or \
            [len(x) for x in stalls] != [2, 1] or meta["n_dev"] != 1 or \
            [r["loss"] for r in run1[2:]] != [r["loss"] for r in run2] or \
            not all(r["loss"] == r["loss"] for r in run1):
        fail(f"torch.distributed.run cli.pretrain: steps "
             f"{[r['step'] for r in run1]} and {[r['step'] for r in run2]}, "
             f"losses {[r['loss'] for r in run1]} and "
             f"{[r['loss'] for r in run2]}, saves {stalls}, {meta}")
    gib = os.path.getsize(os.path.join(second, "step_4.pt")) / 2 ** 30
    return {"wall_s": [s1, s2], "setup_s": setup,
            "losses": [r["loss"] for r in run1],
            "resumed_losses": [r["loss"] for r in run2],
            "async_save_stall_s": stalls[0],
            "async_save_waited_for_previous_s": waits,
            "blocking_save_s": stalls[1][0],
            "checkpoint_gib": gib}


def pretrain_dp(dev, workdir: str) -> dict:
    """The phase: a NCCL group of one on the card (a file store in
    ``workdir``), the gate, the timing and the CLI; the group is destroyed
    at the end.  Neither kernel launches."""
    import torch
    import torch.distributed as dist

    from spmm_tpu_torch.parallel import multihost
    from spmm_tpu_torch.training.pretrain import step_generator

    t0 = time.perf_counter()
    multihost.initialize(dev, init_method=f"file://{workdir}/store",
                         world_size=1, rank=0)
    before = launch_counts()
    out = {"part_s": {"init": time.perf_counter() - t0}}
    try:
        out.update(backend=dist.get_backend(), world=dist.get_world_size())
        for name, fn in (("gate", lambda: dp_gate(dev)),
                         ("timing", lambda: dp_timing(dev)),
                         ("cli", lambda: dp_cli(dev, workdir))):
            t0 = time.perf_counter()
            out[name] = fn()
            out["part_s"][name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if launch_counts() != before:
        fail("the pretrain_dp phase launched a kernel")
    a, b = (torch.rand(4, generator=step_generator(s, 0, dev), device=dev)
            for s in (1, 2))
    out["seed_reaches_card_generator"] = not torch.equal(a, b)
    return out


# --------------------------------------------------------------------------- #
# phase parallel: tp, sp and fsdp at world 1, both kernels at a tp rank's
# heads, predict_pv under the tp plan, sharded inference, attention maps
# --------------------------------------------------------------------------- #


def whole_state(model) -> dict:
    """The model's state dict with every DTensor gathered whole."""
    from spmm_tpu_torch.checkpoint.io import whole

    return whole(model.state_dict())


def compare_parallel(model, ref, loss: float, ref_loss: float,
                     lr: float) -> dict:
    """The "pretrain" gate's bars between a tp, sp or fsdp step and the
    one-process step from the same state on the card: the loss within 1e-5
    relative; each gradient within 1e-4 of its norm plus the gate's floor;
    each parameter within 1e-6 plus lr * |dg| / eps (Adam's slope, as
    ``compare_steps``); the twins within 1e-6; the queues within 1e-5;
    ``queue_ptr`` equal."""
    from spmm_tpu_torch.checkpoint.io import whole
    from spmm_tpu_torch.training.pretrain import EMA_KEYS

    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    if not loss_rel <= 1e-5:
        fail(f"parallel step loss {loss} vs one process {ref_loss}")
    mine = dict(model.named_parameters())
    pairs = [(name, mine[name], p) for name, p in ref.named_parameters()
             if p.requires_grad]
    floor = 1e-6 * max(p.grad.norm().item() for _, _, p in pairs)
    grad_share, param_err = 0.0, 0.0
    for name, pm, pr in pairs:
        dg = whole(pm.grad) - pr.grad
        grad_share = max(grad_share, dg.norm().item()
                         / (1e-4 * pr.grad.norm().item() + floor))
        dp = (whole(pm.detach()) - pr.detach()).abs()
        param_err = max(param_err, dp.max().item())
        excess = (dp - 1e-6 - lr * dg.abs() / 1e-8).max().item()
        if grad_share > 1 or excess > 0:
            fail(f"parallel step differs from the one-process step at "
                 f"{name}: gradient at {grad_share:.2f} of its bar, "
                 f"parameter by {dp.max().item():.2e}")
    got, want = whole_state(model), ref.state_dict()
    twins = {f"{e}_m" for e in EMA_KEYS}
    twin_err = max((got[k] - v).abs().max().item() for k, v in want.items()
                   if k.split(".", 1)[0] in twins)
    queue_err = max((got[k] - want[k]).abs().max().item()
                    for k in ("prop_queue", "text_queue"))
    if not twin_err <= 1e-6 or not queue_err <= 1e-5 or \
            not got["queue_ptr"].equal(want["queue_ptr"]):
        fail(f"parallel step: twins {twin_err:.2e} (bar 1e-6), queues "
             f"{queue_err:.2e} (bar 1e-5), ptr {got['queue_ptr'].tolist()} "
             f"vs {want['queue_ptr'].tolist()}")
    return {"loss": loss, "loss_rel_diff": loss_rel,
            "grad_worst_share_of_bar": grad_share,
            "param_max_abs_diff": param_err, "twin_max_abs_diff": twin_err,
            "queue_max_abs_diff": queue_err}


def parallel_steps(dev) -> dict:
    """parallel (1), under the NCCL group of one: PRETRAIN's batch and
    queue, fp32, dropout on (a generator per chunk from the seed), global
    step 12 of 1000 an epoch.  One state is built once and copied: the
    one-process step, then the step under a (1, 1) dp x tp mesh with the tp
    plan, the same with sp, and under a (1, 1) dp x fsdp mesh with FSDP2,
    each from its own copy; each equals the one-process step at
    ``compare_parallel``'s bars.  Then PAR_TURN steps a turn, in turns (one
    process, tp, sp, fsdp, fsdp, sp, tp, one process), with the memory
    each model keeps between steps and the peak over its steps.  Neither
    kernel launches."""
    import functools

    import torch

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.parallel import mesh
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, make_pretrain_step, step_generator)

    n, queue = PRETRAIN
    pcfg = PretrainConfig(queue_size=queue)
    batch, _ = pretrain_batch(dev, n, SEED + 22)
    start = init_pretrain_state(SEED, pcfg, device=dev)
    before = launch_counts()
    layouts = {"one_process": (None, False), "tp": ("tp", False),
               "tp_sp": ("tp", True), "fsdp": ("fsdp", False)}
    models, steps, gate = {}, {}, {}
    for name, (minor, sp) in layouts.items():
        mesh.clear_mesh()
        if minor is not None:
            mesh.set_mesh(1, 1, minor)
        models[name] = copy.deepcopy(start)
        _, steps[name] = make_pretrain_step(
            models[name], pcfg, 1000, data_parallel=False if minor is None
            else None, sp=sp)
        res = steps[name](12, batch, functools.partial(step_generator, SEED,
                                                       12, dev))
        if res["skipped"]:
            fail(f"the {name} step of the parallel phase was skipped")
        gate[name] = (res["loss"].item(), res["lr"])
    del start
    ref_loss, lr = gate["one_process"]
    out = {"gate": {name: compare_parallel(models[name],
                                           models["one_process"],
                                           gate[name][0], ref_loss, lr)
                    for name in ("tp", "tp_sp", "fsdp")}}
    count = [13]
    turns = {name: [] for name in layouts}
    resident, peak = {}, {}
    for name in ("one_process", "tp", "tp_sp", "fsdp", "fsdp", "tp_sp",
                 "tp", "one_process"):
        torch.cuda.synchronize()
        resident[name] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(PAR_TURN):
            steps[name](count[0], batch, functools.partial(
                step_generator, SEED, count[0], dev))
            count[0] += 1
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) / PAR_TURN)
        peak[name] = max(peak.get(name, 0), torch.cuda.max_memory_allocated())
    mesh.clear_mesh()
    if launch_counts() != before:
        fail("a tp, sp or fsdp pretrain step launched a kernel")
    del models, steps
    torch.cuda.empty_cache()
    out.update(batch=n, queue=queue,
               step_ms={k: 1e3 * sum(v) / len(v) for k, v in turns.items()},
               turns_ms={k: [1e3 * t for t in v] for k, v in turns.items()},
               resident_gib={k: v / 2 ** 30 for k, v in resident.items()},
               peak_gib={k: v / 2 ** 30 for k, v in peak.items()})
    return out


def tp_head_kernels(dev) -> dict:
    """parallel (2): both kernels at a tensor-parallel rank's heads, h=6
    (tp=2) and h=3 (tp=4).  Kernel 2 at every SMILES->PV launch class
    (B=128, D=64, f32) against its plain version at phase 3's bars, and
    timed with its bound as ``time_mha_on`` computes it; kernel 1 at the
    serving shape (bf16 caches, k=2, m=128, T=104, random ancestry) at
    positions 1, 33 and 103 against its plain version, and timed at 103
    with its bound as ``time_kernel`` computes it."""
    import torch

    out = {"fused_mha": [], "beam_decode_attention": [],
           "max_abs_err": {"fused_mha": 0.0, "beam_decode_attention": 0.0}}
    worst, worst2 = {}, {}
    for h in TP_HEADS:
        for n, (label, lq, lk, kind, kv_contig, _) in enumerate(
                s2p_launch_classes()):
            inputs = mha_inputs(dev, 128, h, lq, lk, 64, torch.float32,
                                kind, seed=100 + n, kv_contiguous=kv_contig)
            check_mha(dev, f"h={h} {label}", kind, inputs, worst2)
        for row in time_mha(dev, s2p_launch_classes(), h=h):
            out["fused_mha"].append(dict(row, h=h))
        for pos in (1, 33, 103):
            check_kernel(dev, f"h={h}", kernel_inputs(
                dev, 128, h, 2, 104, 64, 2, torch.bfloat16, pos,
                seed=pos + h), pos, worst)
        out["beam_decode_attention"].append(dict(time_kernel(dev, h=h),
                                                 h=h))
    out["max_abs_err"] = {"fused_mha": worst2["float32"],
                          "beam_decode_attention": worst["bfloat16"]}
    return out


def tp_predict_pv(dev, model) -> dict:
    """parallel (3): fp32 predict_pv of 128 SMILES through kernel 2 with the
    model under the tp plan on a (1, 1) dp x tp mesh, against the
    unsharded model: within 1e-5, and the same 960 launches."""
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.parallel import mesh, tp

    _, ids, mask = s2p_batch()
    mesh.set_mesh(1, 1, "tp")
    try:
        sharded = tp.apply_tp(copy.deepcopy(model))
        reset_launch_counts()
        got, secs, _, launches = run_counted(dev, lambda: predict_pv(
            sharded, ids, mask, device=dev))
        want, want_secs, _, want_launches = run_counted(
            dev, lambda: predict_pv(model, ids, mask, device=dev))
    finally:
        mesh.clear_mesh()
    err = (got - want).abs().max().item()
    if not err <= 1e-5 or launches != S2P_LAUNCHES or \
            want_launches != S2P_LAUNCHES:
        fail(f"predict_pv under the tp plan: {err:.2e} from the unsharded "
             f"run (bar 1e-5), launches {launches} vs {want_launches}")
    del sharded
    return {"max_abs_diff": err, "launches": launches, "tp_s": secs,
            "unsharded_s": want_secs}


def sharded_turns(dev, reps, unsharded, sharded) -> dict:
    """One batch of each kind to warm them (the workers' first launches
    and their kernel libraries' load), then the unsharded and the sharded
    batch in turns (unsharded, sharded, sharded, unsharded), each a main
    path: counts from 0 just before, read just after (this process's for
    the unsharded batch; each worker's for its shard, ``reps.launches``).
    The results of the first of each kind, each run's wall and launches."""
    unsharded()
    sharded()
    out = {"unsharded_s": [], "sharded_s": [], "unsharded_launches": [],
           "shard_launches": []}
    for kind in ("unsharded", "sharded", "sharded", "unsharded"):
        reset_launch_counts()
        res, secs, l1, l2 = run_counted(
            dev, unsharded if kind == "unsharded" else sharded)
        out.setdefault(kind, res)
        out[f"{kind}_s"].append(secs)
        if kind == "unsharded":
            out["unsharded_launches"].append([l1, l2])
        else:
            out["shard_launches"].append(
                [[n["beam_decode_attention"], n["fused_mha"]]
                 for n in reps.launches])
    return out


def sharded_inference(dev, model) -> dict:
    """parallel (4): data-parallel inference with devices=[card, card]: two
    worker processes on one card (parallel.replicas), each with its own
    copy of the weights and a block of 64 rows.  fp32 k=2 beam search of
    128 PVs: seqs equal to the unsharded batch's, logp within 1e-5 + 5e-7
    x |logp|; fp32 predict_pv of 128 SMILES within 1e-5.  The pool's
    start-up (spawn, then each model's weights) is timed apart from the
    batches, which run in turns (``sharded_turns``); each shard launches
    what the unsharded batch launches (as initialised no beam finishes, so
    both shards run all the steps)."""
    import numpy as np
    import torch

    from spmm_tpu_torch.inference import pv2smiles
    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.smiles2pv import predict_pv, predict_pv_rows
    from spmm_tpu_torch.parallel.replicas import Replicas, WorkerPool

    pv = np.random.default_rng(SEED + 30).normal(
        size=(128, 53)).astype(np.float32)
    spec = BeamSpec(k=2, stop_count=2)
    decoder = pv2smiles.decoder_for(model, bf16=False)
    _, ids, mask = s2p_batch()
    out = {"startup_s": {}}
    t0 = time.perf_counter()
    with WorkerPool([dev, dev]) as pool:
        out["startup_s"]["spawn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with pv2smiles.replicas_for(model, pool, bf16=False) as reps:
            out["startup_s"]["pv2smiles_weights"] = time.perf_counter() - t0
            row = sharded_turns(
                dev, reps, lambda: pv2smiles.to_host(pv2smiles._beam_batch(
                    model, decoder, torch.as_tensor(pv, device=dev), None,
                    spec)),
                lambda: pv2smiles.beam_rows(reps, pv, None, spec, None))
        one, got = row.pop("unsharded"), row.pop("sharded")
        want = row["unsharded_launches"][0]
        if not np.array_equal(got["seqs"], one["seqs"]) or \
                not np.allclose(got["logp"], one["logp"], atol=1e-5,
                                rtol=5e-7) or want[0] == 0 or any(
                    launches != want for launches in row["unsharded_launches"]
                    + [shard for run in row["shard_launches"]
                       for shard in run]):
            fail(f"sharded PV->SMILES differs from the unsharded batch: seqs "
                 f"equal {np.array_equal(got['seqs'], one['seqs'])}, "
                 f"launches {row['unsharded_launches']} and by shard "
                 f"{row['shard_launches']}")
        finite = np.isfinite(one["logp"])      # -inf where both are
        out["pv2smiles"] = dict(row, steps=one["steps"],
                                logp_max_abs_diff=float(np.abs(
                                    got["logp"][finite]
                                    - one["logp"][finite]).max()))
        t0 = time.perf_counter()
        with Replicas(model, pool) as reps:
            out["startup_s"]["smiles2pv_weights"] = time.perf_counter() - t0
            row = sharded_turns(
                dev, reps, lambda: predict_pv(model, ids, mask,
                                              device=dev).cpu().numpy(),
                lambda: predict_pv_rows(reps, ids, mask))
        one, got = row.pop("unsharded"), row.pop("sharded")
        err = float(np.abs(got - one).max())
        if not err <= 1e-5 or any(
                launches != [0, S2P_LAUNCHES]
                for launches in row["unsharded_launches"]
                + [shard for run in row["shard_launches"] for shard in run]):
            fail(f"sharded SMILES->PV: {err:.2e} from the unsharded batch "
                 f"(bar 1e-5), launches {row['unsharded_launches']} and by "
                 f"shard {row['shard_launches']} (each {S2P_LAUNCHES})")
        out["smiles2pv"] = dict(row, max_abs_diff=err)
    return out


def attention_maps(dev, model) -> dict:
    """parallel (5): cross_attention_maps at full width, the property
    encoder's hiddens of 8 PVs (54 queries) against the text encoder's of
    8 example SMILES (padded keys), on the card and on a CPU copy: within
    1e-5, every row summing to 1 within 1e-5."""
    import numpy as np
    import torch

    from spmm_tpu_torch.models.introspect import cross_attention_maps

    _, ids, mask = s2p_batch(8)
    pv = torch.as_tensor(np.random.default_rng(SEED + 31).normal(
        size=(8, 53)).astype(np.float32), device=dev)
    with torch.no_grad():
        ids_t, mask_t = (torch.as_tensor(x, device=dev) for x in (ids, mask))
        keys = model.encode_text(ids_t, mask_t)
        queries = model.encode_properties(model.embed_properties(pv, None))
    qmask = torch.ones(queries.shape[:2], dtype=torch.int32, device=dev)
    cpu = copy.deepcopy(model).cpu()
    maps = {}
    t0 = time.perf_counter()
    maps["card"] = cross_attention_maps(model, model.text_cfg, queries, qmask,
                                        keys, mask_t)
    sync(dev)
    card_s = time.perf_counter() - t0
    maps["cpu"] = cross_attention_maps(cpu, cpu.text_cfg, queries.cpu(),
                                       qmask.cpu(), keys.cpu(), mask_t.cpu())
    err = max((a.cpu() - b).abs().max().item()
              for a, b in zip(maps["card"], maps["cpu"]))
    row_err = max((a.sum(-1) - 1).abs().max().item() for a in maps["card"])
    shape = tuple(maps["card"][0].shape)
    cfg = model.text_cfg
    if len(maps["card"]) != cfg.num_hidden_layers - cfg.fusion_layer \
            or not err <= 1e-5 or not row_err <= 1e-5 \
            or shape != (8, cfg.num_attention_heads, 54, ids.shape[1]):
        fail(f"cross_attention_maps: {len(maps['card'])} maps of {shape}, "
             f"card vs CPU {err:.2e}, rows off 1 by {row_err:.2e} (bars "
             f"1e-5)")
    del cpu
    return {"maps": len(maps["card"]), "shape": list(shape),
            "card_vs_cpu_max_abs": err, "row_sum_max_abs_err": row_err,
            "card_s": card_s}


def parallel_phase(dev, workdir: str, model) -> dict:
    """The phase: parts (1)-(3) under a NCCL group of one (a file store in
    ``workdir``), destroyed at the end; then (4) and (5)."""
    import torch.distributed as dist

    from spmm_tpu_torch.parallel import multihost

    out = {"part_s": {}}
    multihost.initialize(dev, init_method=f"file://{workdir}/store",
                         world_size=1, rank=0)
    try:
        for name, fn in (("steps", lambda: parallel_steps(dev)),
                         ("kernels", lambda: tp_head_kernels(dev)),
                         ("tp_predict_pv", lambda: tp_predict_pv(dev, model))):
            t0 = time.perf_counter()
            out[name] = fn()
            out["part_s"][name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    for name, fn in (("sharded", lambda: sharded_inference(dev, model)),
                     ("maps", lambda: attention_maps(dev, model))):
        t0 = time.perf_counter()
        out[name] = fn()
        out["part_s"][name] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- #
# phase pp_ep: pipeline and expert parallelism at full width, the dry run of
# every parallel path, entry(), the native tokenizer
# --------------------------------------------------------------------------- #


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn() over ``iters`` eager calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grad_share(got: list, want: list) -> float:
    """The worst gradient's distance from its reference, as a share of
    1e-4 of the reference's norm plus a floor of 1e-6 of the largest."""
    floor = 1e-6 * max(w.norm().item() for w in want)
    return max((g - w).norm().item() / (1e-4 * w.norm().item() + floor)
               for g, w in zip(got, want))


def pp_full_width(dev, model) -> dict:
    """pp_ep (1): the text section (layers [0, 6), 768 wide, h=12) of the
    full-width model on the embeddings of 128 example SMILES (L=100),
    through ``pipeline_encoder_forward`` on a pipeline group of one stage
    with PP_MICRO microbatches: equal to the sequential BertEncoder
    section within 1e-6; the gradient of sum(out ** 2) by every layer
    parameter within 1e-4 of its norm; under no_grad with "kernel" within
    1e-5 of the plain run, kernel 2 launched 6 x PP_MICRO times (a main
    path: counts from 0 just before, read just after); the pp and the
    sequential forward timed in turns (sequential, pp, pp, sequential);
    kernel 2 at a microbatch's shape (B=32, 100 x 100, padding) against
    its plain version and timed beside its bound and SDPA, as phase 3."""
    import torch

    from spmm_tpu_torch.ops.masks import extend_attention_mask
    from spmm_tpu_torch.parallel import pp

    cfg = model.text_cfg
    bert = model.text_encoder.bert
    layers = bert.encoder.layer[:cfg.fusion_layer]
    group = pp.pp_mesh(1)
    stage = pp.stage_layers(layers, 1, 0)
    _, ids, mask = s2p_batch()
    ids, mask = (torch.as_tensor(x, device=dev) for x in (ids, mask))
    with torch.no_grad():
        hidden = bert.embeddings(ids)
    add = extend_attention_mask(mask)

    def sequential():
        return bert.encoder(hidden, add, mode="text")

    def pipelined(impl: str = "plain"):
        return pp.pipeline_encoder_forward(stage, cfg, hidden, add, group,
                                           PP_MICRO, attention_impl=impl)

    with torch.no_grad():
        want, got = sequential(), pipelined()
    err = (got - want).abs().max().item()
    params = [p for layer in layers for p in layer.parameters()]
    grads = []
    for fn in (sequential, pipelined):
        for p in params:
            p.grad = None
        (fn() ** 2).sum().backward()
        grads.append([p.grad for p in params])
    share = grad_share(grads[1], grads[0])
    for p in params:
        p.grad = None
    del grads
    reset_launch_counts()
    with torch.no_grad():
        kern, _, l1, l2 = run_counted(dev, lambda: pipelined("kernel"))
    kerr = (kern - got).abs().max().item()
    if not err <= 1e-6 or not share <= 1 or not kerr <= 1e-5 or l1 != 0 \
            or l2 != cfg.fusion_layer * PP_MICRO:
        fail(f"pp at full width: {err:.2e} from the sequential section (bar "
             f"1e-6), worst gradient at {share:.3f} of its bar, kernel run "
             f"{kerr:.2e} from the plain one (bar 1e-5), launches {l1}, "
             f"{l2} (want 0, {cfg.fusion_layer * PP_MICRO})")
    turns = {"sequential": [], "pp": []}
    with torch.no_grad():
        for name in ("sequential", "pp", "pp", "sequential"):
            fn = sequential if name == "sequential" else pipelined
            turns[name].append(event_ms(fn, PP_ITERS))
    del want, got, kern
    # kernel 2 at a microbatch's shape, as phase 3 times every launch class
    inputs = mha_inputs(dev, hidden.shape[0] // PP_MICRO, 12, 100, 100, 64,
                        torch.float32, "padding", seed=300)
    check_mha(dev, "pp text", "padding", inputs, {})
    kernel = {"shape": f"B={inputs[0].shape[0]} text 100x100 (a pp "
                       f"microbatch)", "launches_per_batch": l2,
              **time_mha_on(dev, inputs)}
    return {"batch": list(hidden.shape), "micro": PP_MICRO,
            "max_abs_diff": err, "grad_worst_share_of_bar": share,
            "kernel_vs_plain_max_abs": kerr, "kernel2_launches": l2,
            "kernel2": kernel, "turns_ms": turns,
            "ms": {k: sum(v) / len(v) for k, v in turns.items()}}


def moe_full_width(dev) -> dict:
    """pp_ep (2): the GShard MoE block at the text config's width (H=768,
    F=3072), E=8, top-2, capacity factor 1.25, over [64, 100, 768] fp32 in
    8 groups (800 tokens, 250 slots an expert a group): the card against a
    CPU copy within 1e-5, aux_loss and dropped_frac included;
    ``expert_parallel_moe_block`` on an expert group of one equal to
    ``moe_block(n_groups=1)`` within 1e-5; then the block's forward and
    forward + backward and the dense BertLayer.mlp's on the same tokens,
    timed by CUDA events in turns (dense, MoE, MoE, dense)."""
    import torch

    from spmm_tpu_torch.configs import text_config
    from spmm_tpu_torch.models.bert import BertLayer
    from spmm_tpu_torch.parallel import ep

    cfg = text_config()
    n, experts, groups = MOE
    block = ep.init_moe_params(SEED, cfg, experts, device=dev)
    x = torch.randn(n, 100, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(SEED + 40))
    tg = n // groups * 100
    capacity = ep.expert_capacity(tg, experts, 2, 1.25)
    with torch.no_grad():
        out, aux = ep.moe_block(block, cfg, x.to(dev), n_groups=groups)
        cpu, cpu_aux = ep.moe_block(copy.deepcopy(block).cpu(), cfg, x,
                                    n_groups=groups)
        err = (out.cpu() - cpu).abs().max().item()
        aux_err = max(abs(aux[k].item() - cpu_aux[k].item()) for k in aux)
        one, one_aux = ep.expert_parallel_moe_block(block, cfg, x.to(dev),
                                                    ep.ep_mesh(1))
        dense_one, dense_aux = ep.moe_block(block, cfg, x.to(dev))
        ep_err = max([(one - dense_one).abs().max().item()]
                     + [abs(one_aux[k].item() - dense_aux[k].item())
                        for k in one_aux])
    if not err <= 1e-5 or not aux_err <= 1e-5 or not ep_err <= 1e-5:
        fail(f"MoE at full width: card vs CPU {err:.2e}, aux {aux_err:.2e}, "
             f"expert-parallel at world 1 vs dense {ep_err:.2e} (bars 1e-5)")
    del one, dense_one, cpu
    dense = BertLayer(cfg, has_cross=False).to(dev)
    xd = x.to(dev).requires_grad_(True)

    def fwd(moe: bool):
        with torch.no_grad():
            return (ep.moe_block(block, cfg, xd, n_groups=groups) if moe
                    else dense.mlp(xd))

    def fwd_bwd(moe: bool):
        for p in list(block.parameters()) + list(dense.parameters()) + [xd]:
            p.grad = None
        if moe:
            y, a = ep.moe_block(block, cfg, xd, n_groups=groups)
            (y.sum() + a["aux_loss"]).backward()
        else:
            dense.mlp(xd).sum().backward()

    turns = {f"{k}_{m}": [] for k in ("fwd", "fwd_bwd")
             for m in ("dense", "moe")}
    for kind, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        for moe in (False, True, True, False):
            turns[f"{kind}_{'moe' if moe else 'dense'}"].append(
                event_ms(lambda: fn(moe), MOE_ITERS))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    del dense, xd, block
    torch.cuda.empty_cache()
    return {"shape": [n, 100, cfg.hidden_size], "experts": experts,
            "groups": groups, "tokens_per_group": tg, "capacity": capacity,
            "dispatch_mb": n * 100 * experts * capacity * 4 / 1e6,
            "aux_loss": aux["aux_loss"].item(),
            "dropped_frac": aux["dropped_frac"].item(),
            "card_vs_cpu_max_abs": err, "aux_card_vs_cpu": aux_err,
            "ep_world1_vs_dense": ep_err, "turns_ms": turns, "ms": ms,
            "fwd_over_dense": ms["fwd_moe"] / ms["fwd_dense"],
            "fwd_bwd_over_dense": ms["fwd_bwd_moe"] / ms["fwd_bwd_dense"]}


def dryrun_cpu() -> dict:
    """pp_ep (3): ``python -m spmm_tpu_torch.parallel.dryrun --n 4
    --device cpu`` (four gloo ranks: the card's machine has one GPU, and
    NCCL refuses two ranks on one device): every stage OK, its summary
    line; the wall of the subprocess."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spmm_tpu_torch.parallel.dryrun", "--n", "4",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    stages = [line for line in lines if line.startswith("dryrun stage ")]
    summary = [line for line in lines
               if line.startswith("dryrun_multichip(4) OK")]
    if proc.returncode != 0 or len(stages) != 7 or len(summary) != 1:
        fail(f"the dry run on 4 gloo ranks: rc {proc.returncode}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return {"stages": stages, "summary": summary[0], "wall_s": wall}


def entry_loss(dev) -> dict:
    """pp_ep (4): ``dryrun.entry()``'s full-width loss on the card."""
    import math

    import torch

    from spmm_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    fn, args = dryrun.entry(dev)
    with torch.no_grad():
        loss = fn(*args).item()
    secs = time.perf_counter() - t0
    if not math.isfinite(loss) or args[0].text_queue.device.type != "cuda":
        fail(f"entry(): loss {loss} on {args[0].text_queue.device}")
    del fn, args
    torch.cuda.empty_cache()
    return {"loss": loss, "seconds": secs}


def tokenizer_paths() -> dict:
    """pp_ep (5): the native wordpiece is built and in use, and equals the
    Python path on the example SMILES cycled to TOKENIZE_LINES lines (L=100,
    the service's bucket); both timed in lines/s on this host."""
    import numpy as np

    from spmm_tpu_torch.tokenizer import (
        SmilesTokenizer, native_build_error, native_library)

    t0 = time.perf_counter()
    lib = native_library()
    build_s = time.perf_counter() - t0
    tok = SmilesTokenizer()
    if lib is None or tok.native_encoder() is None:
        fail(f"the native tokenizer did not build: {native_build_error()}")
    texts = ["[CLS]" + s for s in example_smiles(TOKENIZE_LINES)]
    out, secs = {}, {}
    for name, t in (("native", tok), ("python", SmilesTokenizer(
            native=False))):
        t0 = time.perf_counter()
        out[name] = t.encode_batch(texts, max_len=100, buckets=(100,))
        secs[name] = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(out["native"],
                                                     out["python"])):
        fail("the native tokenizer differs from the Python path")
    return {"lines": len(texts), "build_s": build_s,
            "lines_per_s": {k: len(texts) / v for k, v in secs.items()}}


def pp_ep_phase(dev, workdir: str, model) -> dict:
    """The phase: parts (1) and (2) under a NCCL group of one (a file
    store in ``workdir``), destroyed at the end; then (3), (4) and (5)."""
    import torch.distributed as dist

    from spmm_tpu_torch.parallel import multihost

    out = {"part_s": {}}

    def part(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        out["part_s"][name] = time.perf_counter() - t0

    multihost.initialize(dev, init_method=f"file://{workdir}/store",
                         world_size=1, rank=0)
    try:
        part("pp", lambda: pp_full_width(dev, model))
        part("moe", lambda: moe_full_width(dev))
    finally:
        dist.destroy_process_group()
    part("dryrun", dryrun_cpu)
    part("entry", lambda: entry_loss(dev))
    part("tokenizer", tokenizer_paths)
    return out


def finetune_eval(dev, calls) -> dict:
    """The fine-tune evaluate_scores on a full-width classification model:
    64 example SMILES and one text of 505 tokens (its own batch, bucket
    512), through kernel 2 (the fine-tune path, recorded) and through the
    plain attention: fp32 within 1e-5, 6 kernel-2 launches per batch.  Then
    eval mol/s over 512 example SMILES (8 batches of 64)."""
    import numpy as np

    from spmm_tpu_torch.cli._common import make_tokenizer
    from spmm_tpu_torch.cli._finetune_driver import evaluate_scores
    from spmm_tpu_torch.data.datasets import SupervisedDataset
    from spmm_tpu_torch.models.downstream import Downstream

    model = Downstream.random_init(SEED, "classification", device=dev)
    tok = make_tokenizer()
    texts = ["[CLS]" + s for s in example_smiles(64)] + [
        "[CLS]" + long_text(490)]
    ds = SupervisedDataset(texts, np.arange(65) % 2)
    reset_launch_counts()                       # the main path starts here
    with calls.recording("fine-tune eval"):     # ... and ends here
        (kp, _), k_s, k1, k2 = run_counted(dev, lambda: evaluate_scores(
            model, tok, ds, batch_size=64))
    (pp, _), p_s, p1, p2 = run_counted(dev, lambda: evaluate_scores(
        model, tok, ds, batch_size=64, attention_impl="plain"))
    err = float(np.abs(kp - pp).max())
    if kp.shape != (65, 2) or not np.isfinite(kp).all():
        fail(f"eval predictions {kp.shape}")
    if not err <= 1e-5:
        fail(f"eval through kernel 2 differs from the plain attention by "
             f"{err:.3e} > 1e-5")
    if k1 or k2 != 2 * 6 or p1 or p2:
        fail(f"eval launches: kernel path ({k1}, {k2}), plain ({p1}, {p2})")
    if not any(key[1][2] == 512 for key in calls.mha):
        fail("the long text did not reach kernel 2 at Lk = 512")
    big = SupervisedDataset(["[CLS]" + s for s in example_smiles(512)],
                            np.arange(512) % 2)
    evaluate_scores(model, tok, big, batch_size=64)
    _, secs, _, n2 = run_counted(dev, lambda: evaluate_scores(
        model, tok, big, batch_size=64))
    return {"max_abs_diff": err, "launches": k2, "kernel_s": k_s,
            "plain_s": p_s, "eval_mol_per_s": 512 / secs,
            "eval_launches_512": n2}


def _write_csv(path: str, header: list, rows: list) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def finetune_clis(dev, workdir: str, calls) -> dict:
    """cli.classification --name bbbp, cli.classification_multilabel --name
    clintox and cli.regression --name esol, each --epoch 2 at full width
    over synthetic CSVs (32 train rows, 16 valid and test rows); then
    cli.rxn_prediction without --evaluate, one epoch of 3 steps over 48
    synthetic reactions, greedy eval of 16 per split, one source of 275
    tokens among them (Lk 288), and checkpoint_best.pt read back strictly.
    Each run is a main path, its kernel calls recorded."""
    import numpy as np
    import torch

    from spmm_tpu_torch.cli import (
        classification, classification_multilabel, regression,
        rxn_prediction)
    from spmm_tpu_torch.models.rxn import Rxn

    runs = (
        ("classification", classification, "bbbp",
         ["num", "name", "p_np", "smiles"],
         lambda i, s: [i, f"m{i}", i % 2, s], 4),
        ("classification_multilabel", classification_multilabel, "clintox",
         ["smiles", "FDA_APPROVED", "CT_TOX"],
         lambda i, s: [s, i % 2, (i // 2) % 2], 4),
        ("regression", regression, "esol",
         ["smiles", "ESOL predicted log solubility in mols per litre"],
         lambda i, s: [s, -3.0 + 0.25 * (i % 9)], 8),
    )
    out = {}
    for name, cli, dataset, header, row, steps in runs:
        data = os.path.join(workdir, f"{name}_data")
        os.makedirs(data)
        for f, n in zip(cli.DATASETS[dataset][1], (32, 16, 16)):
            _write_csv(os.path.join(data, f), header,
                       [row(i, s) for i, s in enumerate(example_smiles(n))])
        result_dir = os.path.join(workdir, f"{name}_out")
        reset_launch_counts()                   # the main path starts here
        with calls.recording(f"cli.{name}"):
            _, secs, n1, n2 = run_counted(dev, lambda: cli.main([
                "--name", dataset, "--data_dir", data, "--epoch", "2",
                "--output_dir", result_dir,
                "--device", dev.type]))           # ... and ends here
        with open(os.path.join(result_dir, "result.json")) as f:
            result = json.load(f)
        # per epoch one eval batch of valid and of test, 6 launches each
        if n1 or n2 != 2 * 2 * 6 or result["steps"] != steps or \
                not np.isfinite(result["best_test"]):
            fail(f"cli.{name}: launches ({n1}, {n2}), result {result}")
        out[name] = {"wall_s": secs, "launches": n2, "steps": steps,
                     "best_valid": result["best_valid"],
                     "best_test": result["best_test"]}

    data = os.path.join(workdir, "rxn_train_data")
    os.makedirs(os.path.join(data, "USPTO-480k"))
    train = rxn_sources(48)
    evals = rxn_sources(16)
    evals[5] = long_text(260)
    for split, sources in (("train", train), ("valid", evals),
                           ("test", evals)):
        with open(os.path.join(data, "USPTO-480k", f"{split}_parsed.txt"),
                  "w") as f:
            f.writelines(f"{s}\t{s.split('.')[0].split()[0]}\n"
                         for s in sources)
    result_dir = os.path.join(workdir, "rxn_train_out")
    reset_launch_counts()                       # the main path starts here
    with calls.recording("cli.rxn_prediction training"):
        _, secs, n1, n2 = run_counted(dev, lambda: rxn_prediction.main([
            "--n_beam", "1", "--epoch", "1", "--data_dir", data,
            "--output_dir", result_dir, "--seed", str(SEED),
            "--device", dev.type]))               # ... and ends here
    with open(os.path.join(result_dir, "result.json")) as f:
        result = json.load(f)
    if n1 <= 0 or n1 % 12 or n2 != 2 * RXN_ENC_LAYERS or result["steps"] != 3:
        fail(f"cli.rxn_prediction training: launches ({n1}, {n2}), result "
             f"{result}")
    if not any(key[1][2] == 288 for key in calls.mha):
        fail("the long source did not reach kernel 2 at Lk = 288")
    saved = torch.load(os.path.join(result_dir, "checkpoint_best.pt"),
                       map_location="cpu")["state_dict"]
    model = Rxn.random_init(SEED + 1, device=dev)
    rxn_prediction.load_rxn_checkpoint(
        model, os.path.join(result_dir, "checkpoint_best.pt"))
    if not all(torch.equal(v.cpu(), saved[k])
               for k, v in model.state_dict().items()):
        fail("checkpoint_best.pt did not load back as saved")
    out["rxn_prediction"] = {"wall_s": secs, "launches": [n1, n2],
                             "steps": result["steps"],
                             "valid_acc": result["best_valid_acc"],
                             "test_acc": result["best_test_acc"]}
    return out


def bench_phase(dev, calls, card: str) -> dict:
    """Each workload of spmm_tpu_torch/bench.py once, through its ``Bench``
    at full width with BENCH_SETUP's counts, as one main path (launches
    counted from 0 over it, kernel calls recorded in ``calls``): every line
    must carry its metric's unit, this card and ``"correct": true``, and
    both kernels must launch."""
    import math

    from spmm_tpu_torch import bench

    runner = bench.Bench(dev, "kernel", bench.Setup(**BENCH_SETUP))
    lines, secs = [], {}
    reset_launch_counts()                       # the main path starts here
    with calls.recording("bench"):
        for name in bench.WORKLOADS:
            t0 = time.perf_counter()
            lines += getattr(runner, name)()
            secs[name] = time.perf_counter() - t0
    launches = launch_counts()                  # ... and ends here
    want = set(bench.UNITS) - {"pv2smiles_beam_k2_throughput_100step"}
    if {ln["metric"] for ln in lines} != want:
        fail(f"the bench printed {sorted(ln['metric'] for ln in lines)}")
    for ln in lines:
        if (ln["unit"] != bench.UNITS[ln["metric"]] or ln["card"] != card
                or ln["correct"] is not True or ln["value"] is None
                or not math.isfinite(ln["value"])):
            fail(f"bench line {json.dumps(ln)}")
    if min(launches) <= 0:
        fail(f"the bench launched the kernels {launches} times")
    return {"lines": lines, "launches": list(launches), "seconds": secs}


def main_path_shapes(dev, calls, worst, worst2) -> list:
    """Each kernel against its plain version, and timed, at every launch
    shape the main paths passed it: kernel 1 on the masks they passed (held
    at the sampled steps and the last, with random q, k_new, v_new and
    cache; timed on the last, bf16 caches only: SDPA takes no fp8), kernel 2
    on the very inputs of its first call."""
    import torch

    rows = []
    for key, masks in calls.kernel1_masks().items():
        m, h, k, T, d, dtype = key
        path = calls.paths[key]
        log(f"  {KERNEL['name']} from {path}:")
        errs = [check_kernel(dev, "main", kernel_inputs(
            dev, m, h, k, T, d, 2, dtype, pos, seed=pos + m + 7 * k,
            mask=mask), pos, worst) for pos, mask in sorted(masks.items())]
        row = {"kernel": KERNEL["name"], "path": path, "m": m, "k": k,
               "T": T, "dtype": str(dtype).replace("torch.", ""),
               "positions": sorted(masks), "max_abs_err": max(errs)}
        if dtype == torch.bfloat16 and (h, d) == (12, 64) and T in (64, 104):
            pos, mask = calls.last[key]
            row.update(time_kernel(dev, m=m, pos=pos, mask=mask, k=k, T=T))
            log_bda_timing(f"{path}, its mask", row)
        rows.append(row)
    for key, inputs in calls.mha.items():
        q, kv, mask = inputs[0], inputs[1], inputs[3]
        kind = ("none" if mask is None else "causal" if mask.shape[-2] > 1
                else "padding")
        path = calls.paths[key]
        log(f"  {KERNEL2['name']} from {path}:")
        row = {"kernel": KERNEL2["name"], "path": path, "B": q.shape[0],
               "Lq": q.shape[2], "Lk": kv.shape[2],
               "dtype": str(q.dtype).replace("torch.", ""), "mask": kind,
               "max_abs_err": check_mha(dev, "main", kind, inputs, worst2),
               **time_mha_on(dev, inputs)}
        log_mha_timing(f"{path}, B={q.shape[0]} {q.shape[2]}x{kv.shape[2]}",
                       row)
        rows.append(row)
    return rows


def headline_decodes(dev, model, calls) -> dict:
    """The bench's headline decodes, recorded in ``calls`` for the phase
    "shapes": one bf16 k=2 PV->SMILES batch of 512 at 60 steps (T=64,
    pv2smiles_beam_k2_throughput) and one at 100 (T=104, its _100step
    line), with the service's mask (no property masked); each batch's
    steps, kernel-1 launches and seconds."""
    import numpy as np
    import torch

    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch, decoder_for

    pv = torch.as_tensor(np.random.default_rng(SEED + 40).normal(
        size=(512, 53)).astype(np.float32), device=dev)
    decoder = decoder_for(model, bf16=True)
    out = {}
    for steps in (60, 100):
        spec = BeamSpec(k=2, stop_count=2, max_steps=steps)
        with calls.recording(f"bench headline, batch 512, {steps} steps"):
            res, secs, l1, _ = run_counted(dev, lambda: _beam_batch(
                model, decoder, pv, torch.zeros_like(pv), spec))
        out[steps] = {"steps": res["steps"], "launches": l1, "s": secs}
    return out


def log_bda_timing(label: str, tm: dict) -> None:
    log(f"  {label} bf16 m={tm['m']} k={tm['k']} pos={tm['pos']} "
        f"T={tm['T']}: kernel "
        f"{tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, sdpa "
        f"{tm['library_ms']:.4f} ms (kernel/sdpa "
        f"{tm['ms'] / tm['library_ms']:.3f}), bound {tm['bound_ms']:.4f} "
        f"ms ({tm['bound_by']}) = {100 * tm['bound_ms'] / tm['ms']:.1f}% of "
        f"the kernel ({tm['live_rows']}/{tm['all_rows']} prefix rows "
        f"attended; all-lane bound {tm['bound_ms_all_lanes']:.4f} ms)")


def log_mha_timing(label: str, row: dict, dtype: str = "f32") -> None:
    log(f"  {label:26s} {dtype}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
        f"(kernel/sdpa {row['ms'] / row['library_ms']:.3f}), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}) = "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of the kernel; sdpa vs "
        f"kernel {row['sdpa_vs_kernel_max_abs']:.2e}")


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

    sync(dev)                     # warm: phase 5 ran this shape
    t0 = time.perf_counter()
    run()
    sync(dev)
    unprofiled = time.perf_counter() - t0
    prof = device_breakdown(run)
    return dict(prof, steps=out["res"]["steps"], unprofiled_wall_s=unprofiled)


def profile_rxn(dev, rxn, batch: int = 128) -> dict:
    """One bf16 rxn greedy batch of bench.py's workload under
    torch.profiler."""
    from spmm_tpu_torch.inference.rxn import _greedy_batch, decoder_for
    from spmm_tpu_torch.utils.profiling import device_breakdown

    decoder = decoder_for(rxn, bf16=True)
    ids, mask = rxn_bench_batch(dev, batch, SEED + 7)
    out = {}

    def run():
        out["res"] = _greedy_batch(rxn, decoder, ids, mask)

    sync(dev)                     # warm: the rxn phase ran this shape
    t0 = time.perf_counter()
    run()
    sync(dev)
    unprofiled = time.perf_counter() - t0
    prof = device_breakdown(run)
    return dict(prof, steps=out["res"]["steps"], unprofiled_wall_s=unprofiled)


def profile_s2p(dev, model) -> dict:
    """One fp32 predict_pv batch of 128 (L=100) under torch.profiler."""
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.utils.profiling import device_breakdown

    _, ids, mask = s2p_batch()

    def run():
        predict_pv(model, ids, mask, device=dev)

    sync(dev)                     # warm: phases 4 and 5 ran this shape
    t0 = time.perf_counter()
    run()
    sync(dev)
    unprofiled = time.perf_counter() - t0
    # top 16: kernel 2's five instantiations must all be listed
    return dict(device_breakdown(run, top=16), unprofiled_wall_s=unprofiled)


# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None,
                        help="a checkout of another commit (git archive): "
                             "time its kernel-2 library beside this one at "
                             "the inputs past 256 keys")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from spmm_tpu_torch.models.rxn import Rxn
        from spmm_tpu_torch.models.spmm import SPMM
        from spmm_tpu_torch.ops import decode_attention, fused_attention
        from spmm_tpu_torch.utils.device import resolve_device
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2

    def mark(phase: str) -> None:
        log(f"-- {phase} at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. device ----
    mark("device")
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

    # ---- 2. build: one nvcc per source, all started together ----
    from concurrent.futures import ThreadPoolExecutor

    from spmm_tpu_torch.ops import _build

    def timed_build(mod) -> float:
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    mark("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        parent_build = None if args.parent is None else pool.submit(
            parent_library, args.parent)
        secs = list(pool.map(timed_build, (decode_attention, fused_attention)))
        parent_lib = None if parent_build is None else parent_build.result()
    log(f"[build] beam_decode_attention {secs[0]:.1f} s, fused_attention "
        f"{secs[1]:.1f} s, together {time.perf_counter() - t0:.1f} s"
        + ("" if parent_lib is None else
           f" (with the kernel-2 source under {args.parent})"))
    for name in ("beam_decode_attention", "fused_attention"):
        report = _build.library_path(name).with_suffix(".log")
        for entry, usage in ptxas_usage(report.read_text()):
            log(f"  ptxas {entry}: {usage}")
            if ("fused_mha_stream_kernel" in entry and
                    "0 bytes spill stores, 0 bytes spill loads" not in usage):
                fail(f"ptxas spills in {entry}: {usage}")
    sass = stream_sass(_build.library_path("fused_attention"))
    for entry, n in sass.items():
        log(f"  cuobjdump -sass {entry}: {n} tensor-core instructions "
            f"(HMMA/HGMMA)")
    occ = occupancy()
    for label, row in occ.items():
        log(f"  occupancy {label}: {row['blocks_per_sm']} blocks per SM, "
            f"{row['dynamic_smem_bytes']} B dynamic shared memory"
            + (f", route {row['route']}, cluster {row['cluster']}"
               if "route" in row else ""))
    reach = long_kernel_reach()
    for name, row in reach.items():
        log(f"  fused_mha {name} D=64 (B=8, h=12, Lq=64): "
            f"fused_mha_long_kernel with 32-row items up to Lk "
            f"{row['rows_32_up_to']}, 16-row items up to "
            f"{row['long_kernel_up_to']}; past it fused_mha_stream_kernel")

    # ---- 3. kernels vs plain ----
    mark("kernels")
    log("[kernels] beam_decode_attention vs plain version")
    worst = compare_kernel(dev)

    timing = time_kernel(dev)
    log_bda_timing("random mask", timing)
    timing_small = time_kernel(dev, m=16)
    log_bda_timing("random mask", timing_small)
    timing_greedy = time_kernel(dev, m=128, pos=100, k=1, kind="greedy")
    log_bda_timing("rxn greedy mask", timing_greedy)
    timing_k5 = time_kernel(dev, m=32, pos=100, k=5)
    log_bda_timing("rxn beam, random mask", timing_k5)
    timing_evidence = time_kernel(dev, m=48, pos=8, k=1, kind="greedy")
    log_bda_timing("rxn evidence greedy mask", timing_evidence)
    log("[kernels] fused_mha vs plain version")
    worst2 = compare_mha(dev)
    timing2 = time_mha(dev, sorted(s2p_launch_classes(),
                                   key=lambda c: c[0] != "fusion-cross 54x100"))
    timing_enc = time_mha(dev, RXN_ENCODER_CLASSES)
    for row in timing2 + timing_enc:
        log_mha_timing(f"{row['shape']} x{row['launches_per_batch']}", row)
    mixed = mixed_eval_inputs(dev)
    check_mha(dev, "mixed eval", "padding", mixed, worst2)
    timing_mixed = {"shape": "B=64 Lk 512, one 505-token text among 63 "
                             "SMILES", **time_mha_on(dev, mixed)}
    log_mha_timing("mixed eval B=64 512x512", timing_mixed)
    timing_stream = time_stream(dev)
    for row in timing_stream:
        log_mha_timing(f"{row['shape']} (cluster {row['cluster']})", row,
                       row["dtype"])
    forced = time_forced_stream(dev, worst2)
    for row in forced:
        log(f"  {row['shape']}, f32: the streaming kernel forced (cluster "
            f"{row['cluster']}) {row['stream_ms']:.4f} ms, the long kernel "
            f"{row['long_ms']:.4f} ms (turns "
            + ", ".join(f"{t:.4f}" for t in row["turns_ms"])
            + f"); forced vs plain {row['max_abs_err']:.2e}")
    mha_batch_ms = sum(r["launches_per_batch"] * r["ms"] for r in timing2)
    log(f"  sum over classes of launches x ms: {mha_batch_ms:.2f} ms of "
        f"kernel 2 per SMILES->PV batch")

    # ---- 4. full-width fp32 exactness ----
    mark("exact")
    t0 = time.perf_counter()
    model = SPMM.random_init(SEED, device=dev)
    log(f"[exact] full-width SPMM random init in "
        f"{time.perf_counter() - t0:.1f} s")
    captured = capture_decoder_mask(dev, model)
    log(f"[kernels] beam_decode_attention on the decoder's mask (last call "
        f"of a bf16 batch of 128, {captured['steps']} steps, pos "
        f"{captured['pos']})")
    check_kernel(dev, "decoder", kernel_inputs(
        dev, 128, 12, 2, 104, 64, 2, torch.bfloat16, captured["pos"], seed=5,
        mask=captured["mask"]), captured["pos"], worst)
    check_kernel(dev, "decoder", kernel_inputs(
        dev, 128, 12, 2, 104, 64, 2, torch.float32, captured["pos"], seed=6,
        mask=captured["mask"]), captured["pos"], worst)
    timing_decoder = time_kernel(dev, pos=captured["pos"],
                                 mask=captured["mask"])
    log_bda_timing("decoder mask", timing_decoder)
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
    exact["smiles2pv"], s2p_ref = exactness_s2p(dev, model)
    res = exact["smiles2pv"]
    log(f"  smiles2pv: fp32 predict_pv of 128 SMILES (L=100), max |pred "
        f"diff| {res['max_abs_diff']:.2e} (max |pred| "
        f"{res['pred_abs_max']:.3f}), {res['launches']} fused_mha launches; "
        f"kernel path {res['kernel_s']:.2f} s, plain {res['plain_s']:.2f} s")
    t0 = time.perf_counter()
    rxn = Rxn.random_init(SEED, device=dev)
    log(f"[exact] full-width reaction model random init in "
        f"{time.perf_counter() - t0:.1f} s")
    # as initialised few rows emit [SEP] (all 100 steps run); a copy with
    # the [SEP] logit raised above every row's least gap runs the stop rule
    bias = sep_gap(dev, rxn, *rxn_batch(dev, 8)) + 1e-3
    sep_biased = copy.deepcopy(rxn.text_encoder)
    with torch.no_grad():
        sep_biased.cls.predictions.bias[3] += bias
    for name, decoder in (("rxn_as_init", rxn.text_encoder),
                          ("rxn_sep_biased", sep_biased)):
        res = exact[name] = exactness_rxn(dev, rxn, decoder)
        log(f"  {name}: fp32 greedy x 8 reactions, {res['greedy_steps']} "
            f"steps, seqs identical, first [SEP] at {res['first_sep']}, "
            f"launches {res['greedy_launches']}; kernel path "
            f"{res['greedy_kernel_s']:.2f} s, plain "
            f"{res['greedy_plain_s']:.2f} s.  fp32 k=5 beam x 4 reactions, "
            f"{res['beam_steps']} steps, seqs identical, n_finished "
            f"{res['n_finished']}, launches {res['beam_launches']}; kernel "
            f"path {res['beam_kernel_s']:.2f} s, plain "
            f"{res['beam_plain_s']:.2f} s")
    exact["rxn_sep_bias"] = bias
    del sep_biased

    # ---- 5. serving: each path is a main path ----
    mark("serving")
    calls = KernelCalls()         # what the main paths pass the kernels
    log("[serving] HTTP -> Pv2SmilesService (bf16, k=2, batch 128)")
    with calls.recording("PV->SMILES serving"):
        serve = serving(dev, model)
    log(f"  {serve['requests']} requests in {serve['batches']} batches, "
        f"{serve['launches']} kernel launches; batch of {128}: "
        f"{serve['batch_call_s']:.3f} s = {serve['mol_per_s']:.1f} mol/s "
        f"({serve['wave2_batches']} batch(es), wall incl. HTTP "
        f"{serve['wave2_wall_s']:.3f} s); kv_fp8 batch "
        f"{serve['kv_fp8_batch_s']:.3f} s = {serve['kv_fp8_mol_per_s']:.1f} "
        f"mol/s ({serve['kv_fp8_same_as_bf16']}/128 same as bf16)")
    log(f"  examples: {serve['examples']}")
    log("[serving] HTTP -> Smiles2PvService (fp32, batch 128)")
    with calls.recording("SMILES->PV serving"):
        serve2 = serving_s2p(dev, model, s2p_ref)
    log(f"  {serve2['requests']} requests in {serve2['batches']} batch(es), "
        f"{serve2['launches']} fused_mha launches; batch call "
        f"{serve2['batch_call_s']:.3f} s = {serve2['mol_per_s']:.1f} mol/s; "
        f"wave wall incl. HTTP {serve2['wave_wall_s']:.3f} s; served vs "
        f"offline {serve2['served_vs_offline_max_abs']:.2e}; empty SMILES "
        f"-> 400")

    # ---- rxn: reaction prediction and the file CLIs, each a main path ----
    import tempfile

    mark("rxn")
    rxn_run = rxn_decoding(dev, rxn, calls)
    log(f"[rxn] bf16 greedy, batch 128, sources of {RXN_SRC_LEN} tokens: "
        f"{rxn_run['greedy_steps']} steps in {rxn_run['greedy_batch_s']:.3f} "
        f"s = {rxn_run['greedy_mol_per_s']:.1f} mol/s, launches "
        f"{rxn_run['greedy_launches']}; predict_beam bf16 k=5 over 32 "
        f"reactions: {rxn_run['beam_call_s']:.3f} s = "
        f"{rxn_run['beam_mol_per_s']:.1f} mol/s, {rxn_run['beam_steps']} "
        f"steps, launches {rxn_run['beam_launches']}; e.g. "
        f"{rxn_run['beam_example']}")
    with tempfile.TemporaryDirectory() as workdir:
        rxn_run["cli"] = rxn_cli(dev, workdir, calls)
        for name, row in rxn_run["cli"].items():
            log(f"[rxn] cli.rxn_prediction --evaluate ({name}): "
                f"{row['wall_s']:.1f} s, accuracy valid {row['valid_acc']} "
                f"test {row['test_acc']}, launches {row['launches']}, "
                f"result.json written")
        rxn_run["pv2smiles_cli"] = pv2smiles_clis(dev, model, workdir,
                                                  calls)
        for name, row in rxn_run["pv2smiles_cli"].items():
            log(f"[rxn] cli.pv2smiles_{name}: {row['wall_s']:.1f} s, "
                f"{row['launches']} kernel-1 launches, "
                f"{row['valid_written']} valid molecules written")

    # ---- finetune: MoleculeNet fine-tunes and reaction training ----
    mark("finetune")
    ft = {"train": finetune_training(dev, rxn)}
    for name, row in ft["train"].items():
        gate, prof = row["gate"], row["profile"]
        log(f"[finetune] {name} train, batch {row['batch']}, dropout on: "
            f"{row['samples_per_s']:.1f} samples/s ({row['step_ms']:.2f} ms "
            f"a step), peak {row['max_memory_gib']:.2f} GiB, loss "
            f"{row['first_loss']:.4f} -> {row['last_loss']:.4f}")
        log(f"  step gate (card vs CPU, dropout off): loss rel diff "
            f"{gate['loss_rel_diff']:.2e} (bar 1e-5), worst gradient at "
            f"{gate['grad_worst_share_of_bar']:.3f} of its bar, parameters "
            f"within {gate['param_max_abs_diff']:.2e} ({gate['params_past_1e-6']} "
            f"elements past 1e-6, each within lr * |dg| / eps of it)")
        log(f"  profile of one step: wall {prof['wall_s'] * 1e3:.2f} ms, "
            + ("device busy not measured (no device events)"
               if prof["busy_share"] is None else
               f"device busy {100 * prof['busy_share']:.1f}%, "
               f"{prof['device_events']} device events"))
        for top in prof["top"]:
            log(f"  {top['ms']:9.3f} ms {top['count']:6d}x  {top['name']}")
    ft["eval"] = finetune_eval(dev, calls)
    row = ft["eval"]
    log(f"[finetune] eval (evaluate_scores, B=64, 64 SMILES + a 505-token "
        f"text): kernel 2 vs plain attention max |diff| "
        f"{row['max_abs_diff']:.2e} (bar 1e-5), {row['launches']} kernel-2 "
        f"launches; {row['eval_mol_per_s']:.1f} mol/s over 512 SMILES")
    with tempfile.TemporaryDirectory() as workdir:
        ft["cli"] = finetune_clis(dev, workdir, calls)
    for name, row in ft["cli"].items():
        log(f"[finetune] cli.{name}: {row['wall_s']:.1f} s, {row['steps']} "
            f"steps, launches {row['launches']}, result.json written"
            + (", checkpoint_best.pt read back" if name == "rxn_prediction"
               else ""))

    # ---- pretrain: the gate, fp32 and bf16 steps, the CLIs ----
    mark("pretrain")
    pt = {"gate": pretrain_gate(dev)}
    gate = pt["gate"]
    log(f"[pretrain] gate, full width, batch {PRETRAIN_GATE[0]}, queue "
        f"{PRETRAIN_GATE[1]}, dropout off, noise fixed (card vs CPU): loss "
        f"{gate['loss']:.5f}, rel diff {gate['loss_rel_diff']:.2e} (bar "
        f"1e-5), worst gradient at {gate['grad_worst_share_of_bar']:.3f} of "
        f"its bar, parameters within {gate['param_max_abs_diff']:.2e} "
        f"({gate['params_past_1e-6']} elements past 1e-6, each within lr * "
        f"|dg| / eps of it), twins {gate['twin_max_abs_diff']:.2e}, queues "
        f"{gate['queue_max_abs_diff']:.2e}, ptr equal")
    for bf16 in (False, True):
        row = pt["bf16" if bf16 else "fp32"] = pretrain_timing(dev, bf16)
        prof = row["profile"]
        log(f"[pretrain] {row['dtype']}{' with remat' if row['remat'] else ''}"
            f", batch {row['batch']}, queue {row['queue']}, dropout on: "
            f"{row['samples_per_s']:.1f} samples/s ({row['step_ms']:.1f} ms "
            f"a step over {PT_TIMED}), {row['flops_per_step'] / 1e12:.2f} "
            f"TFLOP a step (FlopCounterMode), MFU {100 * row['mfu']:.1f}% of "
            f"{row['peak_flops'] / 1e12:.0f} TFLOP/s ({row['dtype']} peak of "
            f"an H100; this card: {card}), peak {row['max_memory_gib']:.2f} "
            f"GiB, loss {row['first_loss']:.4f} -> {row['last_loss']:.4f}")
        log(f"  profile of one step: wall {prof['wall_s'] * 1e3:.1f} ms, "
            + ("device busy not measured (no device events)"
               if prof["busy_share"] is None else
               f"device busy {100 * prof['busy_share']:.1f}%, "
               f"{prof['device_events']} device events"))
        for top in prof["top"]:
            log(f"  {top['ms']:9.3f} ms {top['count']:6d}x  {top['name']}")
    with tempfile.TemporaryDirectory() as workdir:
        pt["cli"] = pretrain_cli(dev, workdir)
        row = pt["cli"]
        log(f"[pretrain] cli.pretrain --max_steps 4 --save_every 2 "
            f"{row['wall_s'][0]:.1f} s, --resume from step_2.pt "
            f"{row['wall_s'][1]:.1f} s (steps 3-4 losses within "
            f"{row['resume_loss_max_abs_diff']:.2e} of the first run's), "
            f"checkpoint {row['checkpoint_gib']:.2f} GiB; "
            f"cli.convert_checkpoint --to_torch {row['wall_s'][2]:.1f} s, "
            f"loaded strictly into an SPMM; {row['mfu_line']}")

        # ---- chain: the resumed checkpoint into both fine-tune CLIs ----
        mark("chain")
        chain = chain_phase(dev, workdir, calls)
    row = chain["loads"]
    log(f"[chain] the resumed step_4.pt's text encoder into a full-width Rxn "
        f"({row['rxn_encoder_tensors']} tensors) and a classification "
        f"Downstream ({row['downstream_encoder_tensors']}): bit for bit")
    for name in ("rxn_prediction", "classification"):
        row = chain[name]
        log(f"[chain] cli.{name} from it, one epoch: {row['wall_s']:.1f} s, "
            f"losses " + ", ".join(f"{x:.4f}" for x in row["losses"])
            + f", launches {row['launches']}, "
            + ", ".join(f"{k} {v}" for k, v in row.items()
                        if k.startswith("best_")) + ", result.json written")
    log(f"[chain] phase {chain['wall_s']:.1f} s")

    # ---- pretrain_dp: the data-parallel step through NCCL at world 1 ----
    mark("pretrain_dp")
    with tempfile.TemporaryDirectory() as workdir:
        dp = pt["dp"] = pretrain_dp(dev, workdir)
    gate, bf = dp["gate"], dp["gate"]["bf16_moments_gate"]
    log(f"[pretrain_dp] {dp['backend']} group of {dp['world']}; gate, full "
        f"width, batch {PRETRAIN_GATE[0]}, queue {PRETRAIN_GATE[1]}, noise "
        f"fixed: the data-parallel step equals the one-process step and "
        f"zero1 equals replicated, bitwise (parameters, twins, queues, ptr; "
        f"loss {gate['losses']['one_process']:.6f}), zero1 keeping "
        f"{gate['zero1_twin_elements_between_steps']} twin elements between "
        f"steps in its shard; bf16_moments card vs "
        f"CPU: loss rel diff {bf['loss_rel_diff']:.2e}, worst gradient at "
        f"{bf['grad_worst_share_of_bar']:.3f} of its bar, parameters within "
        f"{bf['param_max_abs_diff']:.2e} ({bf['params_past_1e-6']} past "
        f"1e-6), twins {bf['twin_max_abs_diff']:.2e}, queues "
        f"{bf['queue_max_abs_diff']:.2e}")
    row = dp["timing"]
    log(f"[pretrain_dp] fp32, batch {row['batch']}, queue {row['queue']}, "
        f"dropout on, turns of {DP_TURN} (one process, data parallel, data "
        f"parallel, one process): one process "
        f"{row['step_ms']['one_process']:.1f} ms a step "
        f"({row['samples_per_s']['one_process']:.1f} samples/s; turns "
        + ", ".join(f"{t:.1f}" for t in row["turns_ms"]["one_process"])
        + f"), data parallel {row['step_ms']['data_parallel']:.1f} ms "
        f"({row['samples_per_s']['data_parallel']:.1f} samples/s; turns "
        + ", ".join(f"{t:.1f}" for t in row["turns_ms"]["data_parallel"])
        + f"): x{row['dp_over_one_process']:.4f}; all-reduce of the "
        f"{row['grad_elements']} gradient elements "
        f"{sum(row['grad_all_reduce_ms']) / len(row['grad_all_reduce_ms']):.3f}"
        f" ms (min {min(row['grad_all_reduce_ms']):.3f}, max "
        f"{max(row['grad_all_reduce_ms']):.3f}), of the loss "
        f"{max(row['loss_all_reduce_ms']):.3f} ms at most; {card}")
    row = dp["cli"]
    log(f"[pretrain_dp] torch.distributed.run cli.pretrain --zero1 "
        f"--bf16_moments --async_save --max_steps 4 --save_every 2 "
        f"{row['wall_s'][0]:.1f} s, the same without --async_save from "
        f"step_2.pt {row['wall_s'][1]:.1f} s, steps 3-4 losses equal; of a "
        f"{row['checkpoint_gib']:.2f} GiB checkpoint the loop stood still "
        + ", ".join(f"{t:.3f}" for t in row["async_save_stall_s"])
        + " s at the async saves (of which waiting for the previous write "
        + ", ".join(f"{t:.3f}" for t in row["async_save_waited_for_previous_s"])
        + f" s), {row['blocking_save_s']:.3f} s at the "
        f"blocking one; the run's seed reaches the card's step generator: "
        f"{dp['seed_reaches_card_generator']}; the CLI's state was ready "
        f"after " + ", ".join(f"{t:.1f}" for t in row["setup_s"]) + " s; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in dp["part_s"].items()))

    # ---- parallel: tp, sp, fsdp at world 1; tp heads; sharded inference ----
    mark("parallel")
    with tempfile.TemporaryDirectory() as workdir:
        par = parallel_phase(dev, workdir, model)
    for name, row in par["steps"]["gate"].items():
        log(f"[parallel] {name} step, full width, batch {PRETRAIN[0]}, queue "
            f"{PRETRAIN[1]}, fp32, dropout on, (1, 1) mesh, vs the "
            f"one-process step: loss {row['loss']:.6f}, rel diff "
            f"{row['loss_rel_diff']:.2e} (bar 1e-5), worst gradient at "
            f"{row['grad_worst_share_of_bar']:.3f} of its bar, parameters "
            f"within {row['param_max_abs_diff']:.2e}, twins "
            f"{row['twin_max_abs_diff']:.2e}, queues "
            f"{row['queue_max_abs_diff']:.2e}, ptr equal")
    row = par["steps"]
    log("[parallel] step ms in turns of "
        f"{PAR_TURN} (one process, tp, tp+sp, fsdp, then back): "
        + "; ".join(f"{k} {row['step_ms'][k]:.1f} ms (turns "
                    + ", ".join(f"{t:.1f}" for t in row["turns_ms"][k])
                    + f"), resident {row['resident_gib'][k]:.2f} GiB, peak "
                    f"{row['peak_gib'][k]:.2f} GiB"
                    for k in row["step_ms"]) + f"; {card}")
    for row in par["kernels"]["fused_mha"]:
        log_mha_timing(f"h={row['h']} {row['shape']} "
                       f"x{row['launches_per_batch']}", row)
    for row in par["kernels"]["beam_decode_attention"]:
        log_bda_timing(f"h={row['h']} random mask", row)
    row = par["tp_predict_pv"]
    log(f"[parallel] predict_pv of 128 SMILES under the tp plan ((1, 1) "
        f"mesh): max |diff| {row['max_abs_diff']:.2e} from the unsharded "
        f"model (bar 1e-5), {row['launches']} fused_mha launches; "
        f"{row['tp_s']:.2f} s, unsharded {row['unsharded_s']:.2f} s")
    row = par["sharded"]
    log(f"[parallel] devices=[{dev}, {dev}], a worker process each: pool "
        f"start-up (off the batch clock) "
        + ", ".join(f"{k} {v:.2f} s" for k, v in row["startup_s"].items()))
    for name, what in (("pv2smiles", "fp32 k=2 beam search of 128 PVs"),
                       ("smiles2pv", "fp32 predict_pv of 128 SMILES")):
        r = row[name]
        log(f"[parallel] sharded {what}: in turns (unsharded, sharded, "
            f"sharded, unsharded) unsharded "
            + ", ".join(f"{t:.3f}" for t in r["unsharded_s"])
            + " s, sharded " + ", ".join(f"{t:.3f}" for t in r["sharded_s"])
            + " s (sharded / unsharded "
            f"{sum(r['sharded_s']) / sum(r['unsharded_s']):.3f}); "
            f"launches (kernel 1, kernel 2) unsharded "
            f"{r['unsharded_launches']}, each shard's "
            f"{r['shard_launches']}; "
            + (f"seqs equal, max |logp diff| {r['logp_max_abs_diff']:.2e}, "
               f"{r['steps']} steps" if name == "pv2smiles" else
               f"max |diff| {r['max_abs_diff']:.2e}") + f"; {card}")
    row = par["maps"]
    log(f"[parallel] cross_attention_maps: {row['maps']} maps of "
        f"{row['shape']}, card vs CPU {row['card_vs_cpu_max_abs']:.2e}, rows "
        f"sum to 1 within {row['row_sum_max_abs_err']:.2e} (bars 1e-5); "
        + ", ".join(f"{k} {v:.1f} s" for k, v in par["part_s"].items()))

    # ---- pp_ep: pp and ep at full width, the dry run, entry(), tokenizer ----
    mark("pp_ep")
    with tempfile.TemporaryDirectory() as workdir:
        ppe = pp_ep_phase(dev, workdir, model)
    row = ppe["pp"]
    log(f"[pp_ep] pipeline over the text section (6 layers, 768 wide), "
        f"{row['batch']} fp32, one stage, {row['micro']} microbatches: max "
        f"|diff| from the sequential section {row['max_abs_diff']:.2e} (bar "
        f"1e-6), worst gradient of sum(out^2) at "
        f"{row['grad_worst_share_of_bar']:.3f} of its bar (1e-4 of its "
        f"norm); under no_grad through kernel 2 "
        f"{row['kernel_vs_plain_max_abs']:.2e} from the plain run (bar "
        f"1e-5), {row['kernel2_launches']} kernel-2 launches; forward "
        + ", ".join(f"{k} {row['ms'][k]:.3f} ms (turns "
                    + ", ".join(f"{t:.3f}" for t in row["turns_ms"][k]) + ")"
                    for k in row["ms"]) + f"; {card}")
    log_mha_timing(ppe["pp"]["kernel2"]["shape"], ppe["pp"]["kernel2"])
    row = ppe["moe"]
    log(f"[pp_ep] MoE block, {row['shape']} fp32, {row['experts']} experts, "
        f"top-2, capacity factor 1.25, {row['groups']} groups of "
        f"{row['tokens_per_group']} tokens, capacity {row['capacity']}, "
        f"dispatch {row['dispatch_mb']:.1f} MB: card vs CPU "
        f"{row['card_vs_cpu_max_abs']:.2e}, aux "
        f"{row['aux_card_vs_cpu']:.2e} (aux_loss {row['aux_loss']:.5f}, "
        f"dropped {row['dropped_frac']:.5f}); expert-parallel at world 1 vs "
        f"dense {row['ep_world1_vs_dense']:.2e} (bars 1e-5); "
        + ", ".join(f"{k} {v:.3f} ms (turns "
                    + ", ".join(f"{t:.3f}" for t in row["turns_ms"][k])
                    + ")" for k, v in row["ms"].items())
        + f": forward x{row['fwd_over_dense']:.2f} the dense block, forward"
        f"+backward x{row['fwd_bwd_over_dense']:.2f}; {card}")
    for line in ppe["dryrun"]["stages"]:
        log(f"[pp_ep] {line}")
    log(f"[pp_ep] {ppe['dryrun']['summary']} (subprocess wall "
        f"{ppe['dryrun']['wall_s']:.1f} s)")
    row = ppe["tokenizer"]
    log(f"[pp_ep] entry(): full-width pretrain loss on the card "
        f"{ppe['entry']['loss']:.5f} ({ppe['entry']['seconds']:.1f} s with "
        f"the state); native tokenizer built in {row['build_s']:.2f} s, "
        f"equal to the Python path over {row['lines']} lines: native "
        f"{row['lines_per_s']['native']:.0f} lines/s, Python "
        f"{row['lines_per_s']['python']:.0f} lines/s; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ppe["part_s"].items()))

    # ---- bench: spmm_tpu_torch/bench.py's workloads, one timed batch each --
    mark("bench")
    bench_run = bench_phase(dev, calls, card)
    for ln in bench_run["lines"]:
        log(f"[bench] {ln['metric']}: {ln['value']:.6g} {ln['unit']} at batch "
            f"{ln['batch']}" + (f", {ln['attention']}" if "attention" in ln
                                else "")
            + f", median {ln['median_batch_ms']:.1f} ms a batch over "
            f"{ln['n_samples']}, correct {ln['correct']}")
    log(f"[bench] launches {bench_run['launches']} (kernel 1, kernel 2); "
        + ", ".join(f"{k} {v:.1f} s" for k, v in bench_run["seconds"].items()))

    # ---- shapes: every launch shape of the main paths vs plain ----
    mark("shapes")
    headline = headline_decodes(dev, model, calls)
    log("[shapes] the bench's headline decodes, bf16 k=2 batch 512: "
        + ", ".join(f"{n} steps ran {r['steps']}, {r['launches']} kernel-1 "
                    f"launches, {r['s']:.3f} s" for n, r in headline.items()))
    log("[shapes] each kernel against its plain version, and timed, at every "
        "launch shape the main paths passed it")
    main_shapes = main_path_shapes(dev, calls, worst, worst2)
    vs_parent = []
    if parent_lib is not None:
        long_rows = [(f"{calls.paths[key]}, B={inputs[0].shape[0]} "
                      f"{inputs[0].shape[2]}x{inputs[1].shape[2]}", inputs)
                     for key, inputs in calls.mha.items()
                     if inputs[1].shape[2] > 256]
        long_rows.append(("mixed eval B=64 512x512", mixed))
        long_rows += stream_inputs(dev)
        log(f"[shapes] kernel 2 past 256 keys against the library built "
            f"from {args.parent} (turns: parent, this, this, parent)")
        vs_parent = long_rows_vs_parent(dev, long_rows, parent_lib)
        for row in vs_parent:
            log(f"  {row['shape']} {row['dtype']}: this {row['ms']:.4f} ms, "
                f"parent {row['parent_ms']:.4f} ms (turns "
                + ", ".join(f"{t:.4f}" for t in row["turns_ms"])
                + f"); parent vs this {row['parent_vs_kernel_max_abs']:.2e}")
    del calls, mixed

    # ---- 6. profile ----
    mark("profile")
    profiles = {"pv2smiles_bf16": profile_batch(dev, model),
                "smiles2pv_fp32": profile_s2p(dev, model),
                "rxn_greedy_bf16": profile_rxn(dev, rxn)}
    for name, prof in profiles.items():
        busy = prof["busy_share"]
        log(f"[profile] {name}, one batch of 128: wall "
            f"{prof['unprofiled_wall_s']:.3f} s unprofiled, "
            f"{prof['wall_s']:.3f} s profiled; device busy "
            + ("not measured (no device events in the trace)" if busy is None
               else f"{prof['device_busy_s']:.3f} s = {100 * busy:.1f}% of "
                    f"the profiled wall, {prof['device_events']} device "
                    f"events"))
        for row in prof["top"]:
            log(f"  {row['ms']:9.3f} ms {row['count']:6d}x  {row['name']}")
    in_profile = sum(row["ms"] for row in profiles["smiles2pv_fp32"]["top"]
                     if "fused_mha" in row["name"])
    log(f"[profile] kernel 2 in the SMILES->PV profile {in_profile:.2f} ms; "
        f"phase 3's sum of launches x ms {mha_batch_ms:.2f} ms")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"serving": serve, "serving_smiles2pv": serve2,
                      "exact": exact, "rxn": rxn_run, "finetune": ft,
                      "pretrain": pt, "chain": chain, "parallel": par,
                      "pp_ep": ppe, "bench": bench_run,
                      "profile": profiles}))
    record = dict(KERNEL, launches=serve["launches"],
                  rxn_launches=rxn_run["greedy_launches"][0],
                  chain_launches=chain["rxn_prediction"]["launches"][0],
                  bench_launches=bench_run["launches"][0],
                  max_abs_err=worst["bfloat16"],
                  max_abs_err_by_cache_dtype=worst, **timing,
                  decoder_mask=timing_decoder, small_batch=timing_small,
                  rxn_greedy_k1=timing_greedy, rxn_beam_k5=timing_k5,
                  evidence_greedy_k1=timing_evidence,
                  main_path_shapes=[row for row in main_shapes
                                    if row["kernel"] == KERNEL["name"]],
                  headline_launches={steps: row["launches"] for steps, row
                                     in headline.items()},
                  tp_heads=par["kernels"]["beam_decode_attention"],
                  tp_heads_max_abs_err=par["kernels"]["max_abs_err"][
                      KERNEL["name"]],
                  sharded_launches=par["sharded"]["pv2smiles"][
                      "shard_launches"][0],
                  occupancy={key: row for key, row in occ.items()
                             if key.startswith(KERNEL["name"])})
    head = timing2[0]
    record2 = dict(KERNEL2, launches=serve2["launches"],
                   max_abs_err=worst2["float32"],
                   max_abs_err_by_dtype=worst2,
                   **{key: head[key] for key in (
                       "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")},
                   rxn_launches=rxn_run["greedy_launches"][1],
                   bench_launches=bench_run["launches"][1],
                   finetune_eval_launches=ft["eval"]["launches"],
                   chain_launches={name: chain[name]["launches"][1] for name
                                   in ("rxn_prediction", "classification")},
                   per_shape=timing2 + timing_enc,
                   mixed_eval=timing_mixed, stream_kernel=timing_stream,
                   stream_forced_at_long_shapes=forced,
                   stream_sass_tensor_core_instructions=sass,
                   long_kernel_reach=reach,
                   long_rows_vs_parent=vs_parent,
                   main_path_shapes=[row for row in main_shapes
                                     if row["kernel"] == KERNEL2["name"]],
                   tp_heads=par["kernels"]["fused_mha"],
                   tp_heads_max_abs_err=par["kernels"]["max_abs_err"][
                       KERNEL2["name"]],
                   tp_predict_pv_launches=par["tp_predict_pv"]["launches"],
                   pp_launches=ppe["pp"]["kernel2_launches"],
                   pp_microbatch=ppe["pp"]["kernel2"],
                   sharded_launches=par["sharded"]["smiles2pv"][
                       "shard_launches"][0],
                   sum_launches_x_ms=mha_batch_ms,
                   profile_ms=in_profile,
                   occupancy={key: row for key, row in occ.items()
                              if key.startswith(KERNEL2["name"])})
    print(json.dumps({"kernels": [record, record2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
