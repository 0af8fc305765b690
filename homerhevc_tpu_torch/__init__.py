"""homerhevc_tpu_torch — the PyTorch/CUDA port of homerhevc_tpu.

The device tier of the JAX package (ops/, engine/intra_encoder.py,
engine/inter_encoder.py) is re-implemented here in PyTorch, module for
module, so a reader finds each counterpart by path. The package owns its
host tier too: config.py, hevc/*, native/* (the C++ CABAC, built with g++
into _build/ at first use), engine/rate_control.py, utils/* and
engine/pipeline.py are copies of the JAX package's modules at the same
paths, and hevc/{intra_pred,inter_syntax,intra_tree}.py hold what the
device path needs from its golden/ oracle. The I, P and B frames the
JAX package codes on golden/ take copies of those host programs
(hevc/{transform,quantize,intra_pred,intra_frame,intra_tree,deblock,
interp,rd_bits,inter_frame}.py), chosen by configuration as the JAX
pipeline chooses them. parallel/mesh.py spreads all-intra frames or IPPP
GOP segments over several devices (slots), one host thread and CUDA
stream per slot.

The coarse motion-search SAD sweep, the one Pallas kernel of the JAX
package, is a hand-written CUDA kernel (csrc/me_sad.cu) built with nvcc at
first use; on a CPU tensor its wrapper runs the plain PyTorch version.

This package imports torch, never jax, and nothing of homerhevc_tpu.
"""

__version__ = "0.1.0"
