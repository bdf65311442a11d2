"""One rank of the port's multi-process tests (tests/test_torch_distributed.py,
the tp, sp and fsdp tests, tests/test_torch_pipeline_parallel.py and
tests/test_torch_expert_parallel.py).

It imports torch and spmm_tpu_torch only: a rank started by
``torch.multiprocessing.spawn`` would re-import the test module, and with
it jax and spmm_tpu.  Four ways to run it:

    python tests/torch_dist_worker.py steps WORKDIR RANK WORLD

joins a gloo group through the file store ``WORKDIR/store``, reads
``WORKDIR/input.pt`` (a port state dict, the configs, global batches and
noise, and a list of scenarios), runs each scenario's data-parallel steps
on this rank's rows and writes ``WORKDIR/<scenario>_rank<RANK>.pt`` (the
state dict, the losses, the optimizer state's element count);

    python tests/torch_dist_worker.py parallel WORKDIR RANK WORLD

joins the group likewise and runs each scenario of ``WORKDIR/input.pt``
on the process-wide mesh it names (``run_parallel``: pretrain steps under
dp x tp, dp x tp with sp, or dp x fsdp; an MLM forward; ``predict_pv``),
writing ``WORKDIR/<scenario>_rank<RANK>.pt``;

    python tests/torch_dist_worker.py blocks WORKDIR RANK WORLD

joins the group likewise and runs each scenario of ``WORKDIR/input.pt``
through the pipeline (``parallel.pp``) or the expert-parallel MoE block
(``parallel.ep``), forward and backward (``run_block``);

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_dist_worker.py cli TEXT_CFG_JSON PROP_CFG_JSON ARGS...

runs ``spmm_tpu_torch.cli.pretrain.main(ARGS)`` with those tiny configs
in place of the full-width ones.
"""

import contextlib
import functools
import json
import sys

import torch

from spmm_tpu_torch.checkpoint.io import (
    model_state, restore_checkpoint, save_checkpoint)
from spmm_tpu_torch.configs import BertArchConfig, PretrainConfig
from spmm_tpu_torch.parallel import mesh, multihost
from spmm_tpu_torch.parallel.mesh import dp_rank, dp_size
from spmm_tpu_torch.training import pretrain


def rows_of(tree: dict, rows) -> dict:
    return {k: v[torch.as_tensor(rows)] for k, v in tree.items()}


def run_scenario(inp: dict, sc: dict, workdir: str) -> dict:
    """``sc``: name, accum, batches (a key of ``inp``), steps, zero1,
    bf16_moments, and optionally resume (a checkpoint to start from) and
    save_at (write a checkpoint after that many steps)."""
    rank, world = dp_rank(), dp_size()
    pcfg = PretrainConfig(**inp["pcfg"], zero1=sc["zero1"],
                          bf16_moments=sc["bf16_moments"])
    model = pretrain.PretrainModel(*inp["configs"], pcfg.embed_dim,
                                   pcfg.queue_size)
    model.load_state_dict(inp["state"], strict=True)
    opt, step = pretrain.make_pretrain_step(
        model, pcfg, inp["steps_per_epoch"], accum=sc["accum"])
    first = 0
    if sc.get("resume"):
        first = restore_checkpoint(sc["resume"], model, opt)
    batches, noises = inp[sc["batches"]]
    losses = []
    for s in range(first, sc["steps"]):
        n = batches[s]["prop"].shape[0]
        rows = multihost.local_rows(n, rank, world, sc["accum"])
        m = step(s, rows_of(batches[s], rows), noise=rows_of(noises[s], rows))
        losses.append(m["loss"].item())
        if sc.get("save_at") == s + 1:
            save_checkpoint(f"{workdir}/{sc['name']}_step{s + 1}.pt", model,
                            opt, s + 1)
    inner = getattr(opt, "optim", opt)
    held = sum(st[k].numel() for st in inner.state.values()
               for k in ("exp_avg", "exp_avg_sq"))
    twins = model.ema_pairs()[0]
    resident = (sum(p.numel() for p in twins) if model.twin_shards is None
                else model.twin_shards.resident_elements())
    return {"state": model_state(model), "losses": losses,
            "opt_elements": held,
            "param_elements": sum(p.numel()
                                  for p in model.online_parameters()),
            "twin_elements": resident,
            "twin_total": sum(p.numel() for p in model.ema_pairs()[1])}


def steps(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{workdir}/store",
                         world_size=world, rank=rank)
    try:
        inp = torch.load(f"{workdir}/input.pt", weights_only=True)
        inp["configs"] = [BertArchConfig(**c) for c in inp["configs"]]
        for sc in inp["scenarios"]:
            torch.save(run_scenario(inp, sc, workdir),
                       f"{workdir}/{sc['name']}_rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def local_elements(tensors) -> int:
    """Elements this rank holds of ``tensors`` (its shard of a DTensor)."""
    return sum((x.to_local() if hasattr(x, "to_local") else x).numel()
               for x in tensors)


def run_parallel(inp: dict, sc: dict, workdir: str) -> dict:
    """``sc``: name, kind ("pretrain", "mlm", "predict_pv" or "finetune"),
    mesh [dp, minor, "tp" | "fsdp"] or None, and per kind:

    - pretrain: accum, steps, sp, dropout (a generator per chunk from
      seed 11, else the fixed noise), optionally pcfg (PretrainConfig
      fields over ``inp["pcfg"]``), resume and save_at;
    - mlm: the BertForMaskedLM of the state's text encoder on ``mlm``'s
      ids, mask and encoder states, dropout on from a generator seeded 5;
    - predict_pv: ``predict_pv`` of this dp rank's rows of ``s2p``;
    - finetune: the classification step of ``make_downstream_step`` on
      ``downstream`` (a Downstream state) over ``ft_batches``, this dp
      rank's rows of each.
    """
    from spmm_tpu_torch.checkpoint.io import whole
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.parallel import sp as sp_mod
    from spmm_tpu_torch.parallel import tp

    mesh.clear_mesh()
    if sc["mesh"] is not None:
        mesh.set_mesh(*sc["mesh"])
    rank, world = dp_rank(), dp_size()
    cpu = torch.device("cpu")
    if sc["kind"] == "finetune":
        from spmm_tpu_torch.configs import FinetuneConfig
        from spmm_tpu_torch.models.downstream import Downstream
        from spmm_tpu_torch.training.finetune import make_downstream_step

        model = Downstream("classification", inp["configs"][0])
        model.load_state_dict(inp["downstream"], strict=True)
        _, step = make_downstream_step(model, FinetuneConfig(**inp["fcfg"]),
                                       inp["ft_steps_per_epoch"])
        losses = []
        for gs, batch in enumerate(inp["ft_batches"]):
            rows = multihost.process_rows(batch["ids"].shape[0], rank, world)
            losses.append(step(gs, {k: v[rows.start:rows.stop]
                                    for k, v in batch.items()})["loss"].item())
        return {"losses": losses, "state": whole(model.state_dict())}
    if sc["kind"] == "predict_pv":
        model = SPMM(*inp["configs"])
        model.load_state_dict(inp["spmm"], strict=True)
        tp.apply_tp(model.eval())
        ids, mask = inp["s2p"]
        rows = multihost.process_rows(ids.shape[0], rank, world)
        rows = torch.arange(rows.start, rows.stop)
        return {"rows": rows, "pv": predict_pv(model, ids[rows], mask[rows],
                                               n_properties=5, device=cpu)}
    pcfg = PretrainConfig(**inp["pcfg"], **sc.get("pcfg", {}))
    model = pretrain.PretrainModel(*inp["configs"], pcfg.embed_dim,
                                   pcfg.queue_size)
    model.load_state_dict(inp["state"], strict=True)
    if sc["kind"] == "mlm":
        tp.apply_tp(model)
        ids, mask, enc = inp["mlm"]
        gen = torch.Generator().manual_seed(5)
        ctx = (sp_mod.sequence_parallel(mesh.minor_mesh()) if sc.get("sp")
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            logits = model.text_encoder(input_ids=ids, attention_mask=mask,
                                        encoder_hidden_states=enc,
                                        is_decoder=True, generator=gen)
        return {"logits": logits}
    opt, step = pretrain.make_pretrain_step(
        model, pcfg, inp["steps_per_epoch"], accum=sc["accum"],
        sp=sc.get("sp", False))
    first = 0
    if sc.get("resume"):
        first = restore_checkpoint(sc["resume"], model, opt)
    batches, noises = inp[sc["batches"]]
    losses = []
    for s in range(first, sc["steps"]):
        n = batches[s]["prop"].shape[0]
        rows = multihost.local_rows(n, rank, world, sc["accum"])
        gen = noise = None
        if sc["dropout"]:
            gen = functools.partial(pretrain.step_generator, 11, s, cpu)
        else:
            noise = rows_of(noises[s], rows)
        m = step(s, rows_of(batches[s], rows), gen, noise)
        losses.append(m["loss"].item())
        if sc.get("save_at") == s + 1:
            save_checkpoint(f"{workdir}/{sc['name']}_step{s + 1}.pt", model,
                            opt, s + 1)
    twins, online = model.ema_pairs()[0], model.online_parameters()
    moments = [st[k] for st in opt.state.values()
               for k in ("exp_avg", "exp_avg_sq")]
    return {"state": whole(model.state_dict()), "losses": losses,
            "held": {"params": local_elements(online),
                     "twins": local_elements(twins),
                     "moments": local_elements(moments)},
            "placements": {name: str(getattr(p, "placements", None))
                           for name, p in model.named_parameters()}}


def parallel(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{workdir}/store",
                         world_size=world, rank=rank)
    try:
        inp = torch.load(f"{workdir}/input.pt", weights_only=True)
        inp["configs"] = [BertArchConfig(**c) for c in inp["configs"]]
        for sc in inp["scenarios"]:
            torch.save(run_parallel(inp, sc, workdir),
                       f"{workdir}/{sc['name']}_rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def run_block(inp: dict, sc: dict) -> dict:
    """``sc``: name, kind and per kind:

    - pp: stages and micro; the text stack of ``inp["pp"]`` (a
      BertEncoder's state, its config, the hidden states and the additive
      mask) through ``pipeline_encoder_forward`` on the first ``stages``
      ranks, then the backward of sum(out ** 2) into the stage's layers and
      the input;
    - ep: top_k; the MoE block of ``inp["ep"]`` (its state, config and the
      hidden states) through ``expert_parallel_moe_block`` over every rank,
      this rank's rows, then the backward of sum(out ** 2) + 0.01 *
      aux_loss / ep (the ranks' losses summed count aux_loss once).
    """
    from spmm_tpu_torch.models.bert import BertEncoder
    from spmm_tpu_torch.parallel import ep, pp

    rank, world = torch.distributed.get_rank(), \
        torch.distributed.get_world_size()
    if sc["kind"] == "pp":
        d = inp["pp"]
        cfg = BertArchConfig(**d["cfg"])
        enc = BertEncoder(cfg)
        enc.load_state_dict(d["state"], strict=True)
        group = pp.pp_mesh(sc["stages"])
        if rank >= sc["stages"]:
            return {}
        stage = pp.stage_layers(enc.layer, sc["stages"], rank)
        first = rank * len(stage)
        hidden = d["hidden"].clone().requires_grad_(True)
        out = pp.pipeline_encoder_forward(stage, cfg, hidden, d["mask"],
                                          group, sc["micro"])
        (out ** 2).sum().backward()
        return {"out": out.detach(), "hidden_grad": hidden.grad,
                "grads": {f"layer.{first + i}.{name}": p.grad
                          for i, layer in enumerate(stage)
                          for name, p in layer.named_parameters()}}
    d = inp["ep"]
    cfg = BertArchConfig(**d["cfg"])
    block = ep.MoEBlock(cfg, d["n_experts"])
    block.load_state_dict(d["state"], strict=True)
    group = ep.ep_mesh(world)
    local = ep.expert_shard(block, rank, world)
    rows = ep.ep_rows(d["hidden"].shape[0], rank, world)
    out, aux = ep.expert_parallel_moe_block(local, cfg, d["hidden"][rows],
                                            group, top_k=sc["top_k"])
    ((out ** 2).sum() + 0.01 * aux["aux_loss"] / world).backward()
    return {"rows": (rows.start, rows.stop), "out": out.detach(),
            "aux": {k: v.detach() for k, v in aux.items()},
            "grads": {name: p.grad for name, p in local.named_parameters()}}


def blocks(workdir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{workdir}/store",
                         world_size=world, rank=rank)
    try:
        inp = torch.load(f"{workdir}/input.pt", weights_only=True)
        for sc in inp["scenarios"]:
            torch.save(run_block(inp, sc),
                       f"{workdir}/{sc['name']}_rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def cli(text_cfg: str, prop_cfg: str, argv: list) -> None:
    from spmm_tpu_torch.cli import pretrain as cli_pretrain

    torch.set_num_threads(1)
    tc, pc = (BertArchConfig(**json.loads(c)) for c in (text_cfg, prop_cfg))
    cli_pretrain.text_config = lambda: tc
    cli_pretrain.property_config = lambda: pc
    cli_pretrain.main(argv)


if __name__ == "__main__":
    if sys.argv[1] in ("steps", "parallel", "blocks"):
        {"steps": steps, "parallel": parallel, "blocks": blocks}[
            sys.argv[1]](sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        cli(sys.argv[2], sys.argv[3], sys.argv[4:])
