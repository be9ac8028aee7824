"""pine_tpu_torch: the PyTorch + CUDA port of pine_tpu's wavefront path tracer.

The package mirrors pine_tpu's layout (core/, scene/, accel/, integrators/,
io/) so each module's counterpart is easy to find.  Plain tensor code is
PyTorch; the traversal kernels are CUDA C++ written for Hopper
(csrc/dense_traverse.cu, csrc/grid_traverse.cu), built with nvcc at first
use, and the SAH builder is host C++ (csrc/bvh_builder.cpp), built with the
system C++ compiler at first use.

Entry points take an explicit ``device`` and default to ``"cuda"``; they run
on the CPU only when the caller passes ``device="cpu"``.  Importing this
package loads no integrator and builds no kernel.
"""
