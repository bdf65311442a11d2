"""The plain reference of the benchmark's configurations: SPMM's BERT
stacks, the property encoder, the 53-step property decode and the
detokenizer, in plain PyTorch over a dict of weights by checkpoint name.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the weights and inputs it made from the seed.  Products
run in fp32 with TF32 off (``Reference`` turns it off), unless fp8 is
asked for as the beam cells' control: every product's operands rounded to
float8_e4m3fn with one scale a tensor, then multiplied in fp32.

A language model's reference is a module of its own, named by its
configuration's ``reference`` key (a path from the checkout's root) and
loaded by ``portbench/drivers/lm_turn.py``.  It gives:

- ``tensor_kinds(cfg)``: checkpoint name -> kind of every tensor, and
  ``make_tensor(cfg, seed, name, shape, kind, device)``: that tensor, made
  from (seed, name), which the program loads and the reference makes again;
- ``Reference(cfg, seed, device, precision="fp32")``, whose ``logits(
  sequences, wanted)`` gives each sequence's logits at its wanted
  positions; ``precision`` "fp8" is the cell's control, "bf16" a witness;
- ``work(cfg, history, rows, turn, answer)``: a turn's needed work, a dict
  that the cell's per-layer readers read (``model_flops`` for ``mfu``).

``latent_moe.py`` is the one for ``moonlight-16b-a3b``.
"""

from portbench.reference.model import Reference, detokenize, load_vocab

__all__ = ["Reference", "detokenize", "load_vocab"]
