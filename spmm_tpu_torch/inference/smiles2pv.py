"""SMILES -> property-vector generation (counterpart of
``spmm_tpu.inference.smiles2pv``; reference d_smiles2pv.py).

The 53 properties are decoded one at a time: start from the learned
property-CLS vector, and at each step i (i) re-encode the whole property
prefix BIDIRECTIONALLY with the 6-layer property encoder, (ii) run the 6
fusion layers as a causal decoder cross-attending over the SMILES hiddens,
(iii) read property i off position i with the MTR head, and (iv) write its
``property_embed`` into slot i+1 (reference d_smiles2pv.py:14-26,46-57).

As in the JAX package, the SMILES section runs once and the fusion layers'
cross-attention K/V are computed once (``precompute_cross_kv``).  Step i
reads only slots 0..i, so it re-encodes exactly those ``i + 1`` slots of a
buffer of ``n_properties + 1``.  The JAX package runs the re-encodes over
a buffer that grows in segments 16 -> 32 -> 54, with the mask
``positions <= i`` cutting out the slots past i, because XLA compiles one
program per shape; PyTorch runs any width without a compile, so the port
computes no masked slot.  Only the order of summation differs.

``predict_pv_rows`` splits a batch's rows over several cards
(``parallel.replicas``), the counterpart of calling JAX's ``predict_pv`` on
rows sharded over a mesh.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from spmm_tpu_torch.inference.decoding import precompute_cross_kv
from spmm_tpu_torch.models.spmm import N_PROPERTIES, SPMM
from spmm_tpu_torch.parallel.replicas import Replicas
from spmm_tpu_torch.utils.device import DeviceLike, check_on, resolve_device

Tensor = torch.Tensor


def cast_params_bf16(model: SPMM) -> SPMM:
    """A bfloat16 copy of ``model``: ``predict_pv`` runs it in bfloat16
    (LayerNorm, scores and softmax still in fp32).  Make it once."""
    return copy.deepcopy(model).to(torch.bfloat16)


@torch.no_grad()
def predict_pv(model: SPMM, input_ids, attention_mask, *,
               n_properties: int = N_PROPERTIES,
               attention_impl: str = "kernel",
               device: DeviceLike = None) -> Tensor:
    """Normalized property predictions, fp32 [B, n_properties].

    ``input_ids`` / ``attention_mask`` [B, L] are SMILES tokens with the
    leading [CLS] dropped (``SmilesTokenizer.encode_batch``), numpy or
    tensors.  ``attention_impl="kernel"`` (the default) runs every attention
    through ``ops.fused_attention.fused_mha``, the hand-written kernel on
    the GPU; "plain" runs the unfused matmul-softmax-matmul.  The model's
    parameter dtype is the compute dtype: a model from ``cast_params_bf16``
    runs in bfloat16."""
    dev = resolve_device(device)
    check_on(model, dev)
    ids = torch.as_tensor(input_ids, device=dev)
    mask = torch.as_tensor(attention_mask, device=dev)
    text_cfg = model.text_cfg
    impl = attention_impl

    text_embeds = model.encode_text(ids, mask, attention_impl=impl)
    cross_kv = precompute_cross_kv(model.text_encoder, text_cfg, text_embeds)

    b, h = ids.shape[0], text_cfg.hidden_size
    buf = torch.zeros((b, n_properties + 1, h),
                      dtype=model.property_cls.dtype, device=dev)
    buf[:, 0] = model.property_cls[0, 0]
    ones = torch.ones(n_properties, dtype=torch.int32,
                      device=dev).expand(b, -1)
    preds = []
    for i in range(n_properties):
        prefix, pmask = buf[:, :i + 1], ones[:, :i + 1]
        prop_embeds = model.encode_properties(prefix, pmask,
                                              attention_impl=impl)
        fused = model.text_encoder.bert(
            encoder_embeds=prop_embeds, attention_mask=pmask,
            cross_kv=cross_kv, encoder_attention_mask=mask,
            is_decoder=True, mode="fusion", attention_impl=impl)
        # the MTR head on position i only
        pred = model.mtr_head_forward(fused[:, i])                    # [B]
        buf[:, i + 1] = model.property_embed(pred[:, None])
        preds.append(pred.float())
    return torch.stack(preds, dim=1)


def _predict_pv_shard(model: SPMM, dev, rows: slice, ids: Tensor,
                      mask: Tensor, **kwargs) -> Tensor:
    """One worker's block of ``predict_pv_rows``."""
    return predict_pv(model, ids, mask, device=dev, **kwargs)


def predict_pv_rows(replicas: Replicas, input_ids, attention_mask,
                    **kwargs) -> np.ndarray:
    """``predict_pv`` of a batch whose rows are split into one contiguous
    block per entry of ``replicas`` (each entry's replica in its own worker
    process); the host predictions [B, n_properties] in row order."""
    return np.concatenate(replicas.map(_predict_pv_shard, input_ids,
                                       attention_mask, **kwargs))
