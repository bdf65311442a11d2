"""PV -> SMILES by batched k-beam search: ``inference.pv2smiles._beam_batch``
over a batch of normalised PVs, the result brought to the host and the best
beam of each molecule detokenized, as ``generate_batched`` does."""

from __future__ import annotations

import torch

from portbench import counts
from portbench import traffic as traffic_mod
from portbench.drivers._beams import BeamDriver
from portbench.drivers._common import bert_arch


class Driver(BeamDriver):
    decoder_key = "text"

    def model_class(self):
        from spmm_tpu_torch.models.spmm import SPMM

        return SPMM

    def archs(self) -> tuple:
        return (bert_arch(self.config["text"]),
                bert_arch(self.config["property"]))

    def inputs(self, stream: int, i: int):
        host = traffic_mod.make_batch(self.traffic, self.seed, stream, i,
                                      self.config["n_properties"])
        return host, torch.as_tensor(host["pv"], device=self.dev)

    def decode(self, pv):
        from spmm_tpu_torch.inference.pv2smiles import _beam_batch

        return _beam_batch(self.model, self.decoder, pv, None, self.spec(),
                           kv_fp8=self.cache == "fp8")

    def strings(self, res: dict) -> list:
        from spmm_tpu_torch.inference.pv2smiles import _decode_beams

        return [[_decode_beams(self.tok, res, r, self.k, False, self.py_rng)]
                for r in range(res["seqs"].shape[0])]

    def work(self, host: dict, res: dict) -> dict:
        text, prop = self.config["text"], self.config["property"]
        m, k = res["seqs"].shape[:2]
        le = self.config["n_properties"] + 1
        steps = res["steps"]
        heads = text["num_attention_heads"]
        return {
            "model_flops": counts.pv_prologue(text, prop, m,
                                              self.config["n_properties"])
            + counts.beam_decode(text, m, k, steps, m * le),
            "peak_flops": counts.PEAK_FLOPS[self.traffic["decoder_dtype"]],
            "steps": steps,
            "k1": counts.k1_batch_bound_s(m, k, heads,
                                          text["hidden_size"] // heads,
                                          steps, text["num_hidden_layers"],
                                          self.cache),
        }

    def ref_inputs(self, ref, pv):
        """The reference's encoding of the entry point's inputs."""
        cross = ref.encode_pv(pv)
        return cross, torch.ones(cross.shape[:2], device=self.dev)

    def ref_encode(self, ref, picked: list, hosts: dict):
        return self.ref_inputs(ref, torch.stack(
            [torch.as_tensor(hosts[i]["pv"][r])
             for i, _, r in picked]).to(self.dev))
