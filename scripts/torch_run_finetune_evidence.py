"""Fine-tune evidence run of the PyTorch port (counterpart of
scripts/run_finetune_evidence.py): the reference's downstream loop,
pretrain checkpoint -> fine-tune -> metric (d_rxn_prediction.py:27-145,
d_classification.py:52-103), end to end on the GPU, from a checkpoint the
port's own pretraining wrote.

Three phases; each CLI runs in a process of its own so that it owns the
card:

  0. the pretrain checkpoint: ``--pretrain_ckpt`` if given, else the newest
     ``step_*.pt`` under <convergence_workdir>/phaseB, then phaseA (the
     files scripts/torch_run_convergence.py leaves), else a fresh
     ``cli.pretrain --max_steps N`` on that script's corpus;
  1. reaction fine-tune (``cli.rxn_prediction --mode forward``) on a
     synthetic condensation task (reactants "A.B" -> product AB), then the
     CLI's own greedy eval: exact match;
  2. MoleculeNet-style classification (``cli.classification --name
     bbbp``) on a synthetic has-nitrogen task: test AUROC.

Gates (the JAX script's): both per-step loss streams fall (mean of the
first 20 steps against the last 20), the reaction test exact match is
above 0, the test AUROC above 0.7.  The data (``make_rxn_data``,
``make_cls_data``) are the JAX script's, byte for byte.  Outputs:
<evidence_dir>/torch_finetune_summary.json, torch_metrics_rxn_finetune.jsonl
and torch_metrics_cls_finetune.jsonl.  Exits 1 when a gate fails.

    python scripts/torch_run_finetune_evidence.py [--pretrain_ckpt PATH]
        [--device cuda|cpu] [--workdir DIR] [--convergence_workdir DIR]
        [--evidence_dir DIR]

Without a GPU it stops unless given ``--device cpu``.  Each CLI runs
through ``run(module, argv)`` as in torch_run_convergence.py.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import re
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_run_convergence import (  # noqa: E402  (a sibling script)
    REPO, card_info, default_workdir, make_corpus, pretrain_argv, run_module)

# ring-digit-free second fragments: concatenation stays syntactically valid
FIRST = ["CC(=O)O", "c1ccccc1", "CCO", "CCN", "C1CCCCC1", "CC(C)O",
         "CCCl", "OC=O", "c1ccncc1", "COC", "CC#N", "CCC=O", "CNC", "CCS",
         "c1ccco1", "CC(C)C"]
SECOND = ["CC", "CCO", "N", "Cl", "C(=O)O", "CC(C)C", "OC", "CCN", "Br",
          "C#N", "CCC", "O", "CCCC", "NC", "S", "CCl"]
RXN_TRAIN, RXN_EVAL = 1536, 48
CLS_TRAIN, CLS_EVAL = 512, 128
MIN_AUROC = 0.7


def make_rxn_data(path: str, n_train: int, n_eval: int, seed: int = 0):
    """Forward-synthesis TSVs 'A.B<TAB>AB' over the FIRST x SECOND pairs
    (a copy of the JAX script's: the same files).  Valid and test are drawn
    from the train pairs: the gate is that the model learns the transform
    it was trained on, not held-out generalization."""
    rng = random.Random(seed)
    pairs = [(a, b) for a in FIRST for b in SECOND]   # 256 unique
    rng.shuffle(pairs)

    def lines(n, pool):
        return [f"{a}.{b}\t{a}{b}" for a, b in (rng.choice(pool)
                                                for _ in range(n))]

    d = os.path.join(path, "USPTO-480k")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "train_parsed.txt"), "w") as f:
        f.write("\n".join(lines(n_train, pairs)) + "\n")
    for split in ("valid", "test"):
        with open(os.path.join(d, f"{split}_parsed.txt"), "w") as f:
            f.write("\n".join(lines(n_eval, pairs)) + "\n")
    return path


def make_cls_data(path: str, n_train: int, n_eval: int, seed: int = 0):
    """BBBP-format CSVs where p_np = 'the molecule holds nitrogen' (a copy
    of the JAX script's: the same files)."""
    rng = random.Random(seed)
    os.makedirs(path, exist_ok=True)
    n_frag = [f for f in FIRST + SECOND if "N" in f.upper()]
    o_frag = [f for f in FIRST + SECOND if "N" not in f.upper()]

    def rows(n):
        out = []
        for i in range(n):
            pos = i % 2 == 0
            bank = n_frag if pos else o_frag
            s = rng.choice(bank) + rng.choice(
                [f for f in o_frag if not any(c in f for c in "()")])
            out.append((s, 1 if pos else 0))
        return out

    for name, n in (("BBBP_train.csv", n_train), ("BBBP_valid.csv", n_eval),
                    ("BBBP_test.csv", n_eval)):
        with open(os.path.join(path, name), "w") as f:
            f.write("smiles,p_np\n")
            f.write("\n".join(f"{s},{y}" for s, y in rows(n)) + "\n")
    return path


def loss_window_means(metrics_path: str, w: int = 20):
    """(mean of the first w losses, of the last w, count), w at most half
    of them."""
    with open(metrics_path) as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    w = min(w, max(len(losses) // 2, 1))
    return (sum(losses[:w]) / w, sum(losses[-w:]) / w, len(losses))


def step_of(path: str) -> int:
    return int(os.path.basename(path)[len("step_"):-len(".pt")])


def find_pretrain_ckpt(workdir: str):
    """The newest step_<n>.pt of phase B, else of phase A, else None."""
    for phase in ("phaseB", "phaseA"):
        hits = glob.glob(os.path.join(workdir, phase, "step_*.pt"))
        if hits:
            return max(hits, key=step_of)
    return None


def finetune_summary(rxn_losses: tuple, rxn_result: dict,
                     cls_losses: tuple, cls_result: dict) -> dict:
    """The JAX script's record and gates from each fine-tune's (first-20
    mean, last-20 mean, steps) and its result.json."""
    rxn_first, rxn_last, rxn_steps = rxn_losses
    cls_first, cls_last, cls_steps = cls_losses
    summary = {
        "rxn": {
            "task": "forward condensation A.B -> AB (synthetic USPTO format)",
            "steps": rxn_steps,
            "loss_first20_mean": rxn_first,
            "loss_last20_mean": rxn_last,
            "loss_decreased": rxn_last < rxn_first,
            "best_valid_exact_match": rxn_result["best_valid_acc"],
            "best_test_exact_match": rxn_result["best_test_acc"],
            "epochs": rxn_result["epochs"],
        },
        "classification": {
            "task": "has-nitrogen BBBP-format (synthetic)",
            "steps": cls_steps,
            "loss_first20_mean": cls_first,
            "loss_last20_mean": cls_last,
            "loss_decreased": cls_last < cls_first,
            "best_valid_auroc": cls_result["best_valid"],
            "best_test_auroc": cls_result["best_test"],
            "epochs": cls_result["epochs"],
        },
    }
    summary["ok"] = (summary["rxn"]["loss_decreased"]
                     and summary["classification"]["loss_decreased"]
                     and rxn_result["best_test_acc"] > 0.0
                     and cls_result["best_test"] > MIN_AUROC)
    return summary


def finetune(args, run=run_module) -> dict:
    """The three phases and the summary (written to ``args.evidence_dir``)."""
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.evidence_dir, exist_ok=True)
    walls = {}

    # ---- phase 0: a pretrain checkpoint ---------------------------------
    ckpt = args.pretrain_ckpt or find_pretrain_ckpt(args.convergence_workdir)
    source = "given" if args.pretrain_ckpt else "convergence_run"
    if ckpt is None or not os.path.isfile(ckpt):
        source = "fresh_pretrain"
        corpus, cache = make_corpus(args.workdir, n=20_000)
        out = os.path.join(args.workdir, "pretrain")
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        run("spmm_tpu_torch.cli.pretrain", pretrain_argv(
            corpus, cache, out, args.pretrain_steps, args.pretrain_steps, 32,
            args.device))
        walls["pretrain"] = time.perf_counter() - t0
        ckpt = os.path.join(out, f"step_{args.pretrain_steps}.pt")
    ckpt = os.path.abspath(ckpt)
    print("pretrain checkpoint:", ckpt, f"({source})", flush=True)

    # ---- phase 1: reaction fine-tune, greedy exact match ----------------
    rxn_data = make_rxn_data(os.path.join(args.workdir, "rxn_data"),
                             n_train=RXN_TRAIN, n_eval=RXN_EVAL)
    rxn_out = os.path.join(args.workdir, "rxn_out")
    shutil.rmtree(rxn_out, ignore_errors=True)
    t0 = time.perf_counter()
    output = run("spmm_tpu_torch.cli.rxn_prediction", [
        "--checkpoint", ckpt, "--mode", "forward", "--data_dir", rxn_data,
        "--output_dir", rxn_out, "--epoch", str(args.rxn_epochs),
        "--n_beam", "1", "--batch_size", "16", "--batch_size_eval", "48",
        "--device", args.device])
    walls["rxn"] = time.perf_counter() - t0
    seed = re.search(r"^seed: (\d+)$", output, re.M)

    # ---- phase 2: classification fine-tune, AUROC -----------------------
    cls_data = make_cls_data(os.path.join(args.workdir, "cls_data"),
                             n_train=CLS_TRAIN, n_eval=CLS_EVAL)
    cls_out = os.path.join(args.workdir, "cls_out")
    shutil.rmtree(cls_out, ignore_errors=True)
    t0 = time.perf_counter()
    run("spmm_tpu_torch.cli.classification", [
        "--checkpoint", ckpt, "--name", "bbbp", "--data_dir", cls_data,
        "--output_dir", cls_out, "--epoch", str(args.cls_epochs),
        "--batch_size", "16", "--device", args.device])
    walls["classification"] = time.perf_counter() - t0

    # ---- summary and gates ----------------------------------------------
    results = []
    for out in (rxn_out, cls_out):
        with open(os.path.join(out, "result.json")) as f:
            results.append(json.load(f))
    body = finetune_summary(
        loss_window_means(os.path.join(rxn_out, "metrics.jsonl")),
        results[0],
        loss_window_means(os.path.join(cls_out, "metrics.jsonl")),
        results[1])
    body["rxn"]["seed"] = int(seed.group(1)) if seed else None
    summary = {"device": args.device, "pretrain_ckpt": ckpt,
               "pretrain_ckpt_source": source, **body, **card_info(),
               "wall_s": walls}
    summary["ok"] = summary.pop("ok")             # last, as in JAX's file
    for out, name in ((rxn_out, "rxn"), (cls_out, "cls")):
        shutil.copyfile(os.path.join(out, "metrics.jsonl"), os.path.join(
            args.evidence_dir, f"torch_metrics_{name}_finetune.jsonl"))
    with open(os.path.join(args.evidence_dir,
                           "torch_finetune_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pretrain_ckpt", default=None)
    ap.add_argument("--pretrain_steps", type=int, default=300,
                    help="fallback pretrain length when no checkpoint found")
    ap.add_argument("--rxn_epochs", type=int, default=6)
    ap.add_argument("--cls_epochs", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--workdir",
                    default=default_workdir("spmm_torch_finetune_evidence"))
    ap.add_argument("--convergence_workdir",
                    default=default_workdir("spmm_torch_convergence"))
    ap.add_argument("--evidence_dir", default=os.path.join(REPO, "evidence"))
    return ap.parse_args(argv)


def main(argv=None, run=run_module) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from spmm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)         # no GPU and no --device cpu: raise
    summary = finetune(args, run)
    if not summary["ok"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
