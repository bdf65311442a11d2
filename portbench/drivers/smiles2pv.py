"""SMILES -> PV: ``inference.smiles2pv.predict_pv`` over a batch of
tokenized SMILES (the leading [CLS] dropped, padded to a bucket as the CLI
pads), the predictions brought to the host.

The comparison takes a sample of the window's rows drawn from the seed,
with the longest text in it, and the reference's predictions of the same
rows at their own lengths:

- ``pv_error``: the largest |program - reference| over the sampled rows and
  the 53 properties, over the reference's root mean square;
- ``missing_rows``: rows of a batch with no finite prediction.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench import traffic as traffic_mod
from portbench import weights
from portbench.drivers._common import bert_arch, on_device, phase, sample
from portbench.reference import Reference

CHECK_BLOCK = 64


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        self.config, self.traffic, self.seed, self.dev = (
            config, traffic, seed, device)
        self.control = control

    def setup(self) -> None:
        from spmm_tpu_torch.models.spmm import SPMM
        from spmm_tpu_torch.utils.device import fp32_matmuls

        fp32_matmuls()
        if self.control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        with phase("model and weights", self.dev):
            self.model = on_device(SPMM, self.config, self.seed, self.dev,
                                   bert_arch(self.config["text"]),
                                   bert_arch(self.config["property"]))
        with phase("warm-up batch", self.dev):
            self.run(self.inputs(traffic_mod.WARM_UP, 0)[1])

    def inputs(self, stream: int, i: int):
        host = traffic_mod.make_batch(self.traffic, self.seed, stream, i)
        return host, (torch.as_tensor(host["ids"], device=self.dev),
                      torch.as_tensor(host["mask"], device=self.dev))

    def run(self, x) -> dict:
        from spmm_tpu_torch.inference.smiles2pv import predict_pv

        ids, mask = x
        pv = predict_pv(self.model, ids, mask,
                        n_properties=self.config["n_properties"],
                        attention_impl=self.traffic["attention"],
                        device=self.dev)
        return {"pv": pv.cpu().numpy()}

    def units(self, res: dict) -> int:
        return int(res["pv"].shape[0])

    def free(self) -> None:
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def work(self, host: dict, res: dict) -> dict:
        text, prop = self.config["text"], self.config["property"]
        lengths = [int(n) for n in host["lengths"]]
        n_props = self.config["n_properties"]
        dtype = self.traffic["dtype"]
        return {
            "model_flops": counts.smiles2pv(text, prop, lengths, n_props),
            "peak_flops": counts.PEAK_FLOPS[dtype],
            "k2": counts.k2_smiles2pv_bound_s(text, prop, lengths, n_props,
                                              dtype),
        }

    def check(self, batches: list, extra: bool = False) -> list:
        limits = self.traffic["limits"]
        rows = [(i, res, r) for i, res in batches
                for r in range(res["pv"].shape[0])]
        hosts = {i: traffic_mod.make_batch(self.traffic, self.seed,
                                           traffic_mod.WINDOW, i)
                 for i, _ in batches}
        picked = sample(rows, lambda row: int(hosts[row[0]]["lengths"][row[2]]),
                        self.seed, self.traffic["check_rows"])
        missing = sum(int(not np.isfinite(res["pv"][r]).all())
                      for _, res, r in rows)
        ref = Reference(self.config, weights.make(self.config, self.seed,
                                                  self.dev))
        got, want = [], []
        for start in range(0, len(picked), CHECK_BLOCK):
            block = picked[start:start + CHECK_BLOCK]
            width = max(int(hosts[i]["lengths"][r]) for i, _, r in block)
            ids = torch.stack([torch.as_tensor(hosts[i]["ids"][r][:width])
                               for i, _, r in block]).long().to(self.dev)
            mask = torch.stack([torch.as_tensor(hosts[i]["mask"][r][:width])
                                for i, _, r in block]).to(self.dev)
            want.append(ref.smiles2pv(ids, mask).cpu())
            got.append(torch.stack([torch.as_tensor(res["pv"][r])
                                    for _, res, r in block]))
        got, want = torch.cat(got), torch.cat(want)
        err = float((got - want).abs().max()
                    / want.pow(2).mean().sqrt().clamp_min(1e-30))
        return [("pv_error", err, limits["pv_error"]),
                ("missing_rows", missing, 0)]
