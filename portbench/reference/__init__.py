"""The plain reference of the benchmark's configurations: SPMM's BERT
stacks, the property encoder, the 53-step property decode and the
detokenizer, in plain PyTorch over a dict of weights by checkpoint name.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the weights and inputs it made from the seed.  Products
run in fp32 with TF32 off (``Reference`` turns it off), unless fp8 is
asked for as the beam cells' control: every product's operands rounded to
float8_e4m3fn with one scale a tensor, then multiplied in fp32.
"""

from portbench.reference.model import Reference, detokenize, load_vocab

__all__ = ["Reference", "detokenize", "load_vocab"]
