"""tpusdr — software-defined-radio signal-processing framework on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
kernrj/cuda-sdr (gpusdrpipeline): streaming SDR demodulation graphs
(sources -> format conversion -> frequency translation -> decimating FIR ->
quadrature demodulation -> audio resampling -> sinks) expressed as pure
``(state, block) -> (state, block)`` functions compiled per streaming block,
sharded over device meshes by channel and time-block with overlap-save halo
exchange.

Design stance (see SURVEY.md section 7): the reference's CUDA/C++ object
graph (IRef refcounting, request/commit buffer protocol, SteppingDriver
demand recursion — reference src/driver/SteppingDriver.cpp:193-245) is
an artifact of mutable GPU buffers; under XLA the same semantics collapse into
static shape arithmetic + carry-state pytrees + XLA's async scheduler.
"""

__version__ = "0.1.0"

from tpusdr.graph.block import Block  # noqa: F401
from tpusdr.graph.chain import Chain  # noqa: F401
from tpusdr.graph.registry import get_registry, register_block  # noqa: F401
