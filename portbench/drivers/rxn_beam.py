"""Reaction prediction by k-beam search: ``inference.rxn._beam_batch`` (the
path of ``predict_beam``) over a batch of tokenized sources, the result
brought to the host and every available beam detokenized, as
``predict_beam`` does."""

from __future__ import annotations

import torch

from portbench import counts
from portbench import traffic as traffic_mod
from portbench.drivers._beams import BeamDriver
from portbench.drivers._common import bert_arch


class Driver(BeamDriver):
    decoder_key = "decoder"

    def model_class(self):
        from spmm_tpu_torch.models.rxn import Rxn

        return Rxn

    def archs(self) -> tuple:
        return (bert_arch(self.config["decoder"]),
                bert_arch(self.config["encoder"]))

    def inputs(self, stream: int, i: int):
        host = traffic_mod.make_batch(self.traffic, self.seed, stream, i)
        return host, (torch.as_tensor(host["ids"], device=self.dev),
                      torch.as_tensor(host["mask"], device=self.dev))

    def decode(self, x):
        from spmm_tpu_torch.inference import rxn
        from spmm_tpu_torch.inference.decoding import beam_search_batched

        ids, mask = x
        if self.cache != "fp8":
            return rxn._beam_batch(self.model, self.decoder, ids, mask,
                                   self.spec())
        with torch.no_grad():
            enc = rxn._encode(self.model, self.decoder, ids, mask,
                              self.traffic["attention"])
        return beam_search_batched(self.decoder, self.model.decoder_cfg, enc,
                                   mask, self.spec(),
                                   cache_dtype=torch.float8_e4m3fn)

    def strings(self, res: dict) -> list:
        out = []
        for r in range(res["seqs"].shape[0]):
            out.append([self.tok.decode(
                res["seqs"][r, j, :max(int(res["lengths"][r, j]) - 1, 1)])
                for j in range(self.n_avail(res, r))])
        return out

    def work(self, host: dict, res: dict) -> dict:
        dec, enc = self.config["decoder"], self.config["encoder"]
        m, k = res["seqs"].shape[:2]
        lengths = [int(n) for n in host["lengths"]]
        steps = res["steps"]
        heads = dec["num_attention_heads"]
        return {
            "model_flops": counts.rxn_prologue(enc, dec, lengths)
            + counts.beam_decode(dec, m, k, steps, sum(lengths)),
            "peak_flops": counts.PEAK_FLOPS[self.traffic["decoder_dtype"]],
            "steps": steps,
            "k1": counts.k1_batch_bound_s(m, k, heads,
                                          dec["hidden_size"] // heads, steps,
                                          dec["num_hidden_layers"],
                                          self.cache),
            "k2": counts.k2_encoder_bound_s(enc, lengths,
                                            enc["num_hidden_layers"],
                                            self.traffic["encoder_dtype"]),
        }

    def ref_inputs(self, ref, x):
        """The reference's encoding of the entry point's inputs."""
        ids, mask = x
        return ref.encode_source(ids.long(), mask), mask

    def ref_encode(self, ref, picked: list, hosts: dict):
        return self.ref_inputs(ref, tuple(
            torch.stack([torch.as_tensor(hosts[i][key][r])
                         for i, _, r in picked]).to(self.dev)
            for key in ("ids", "mask")))
