"""PyTorch + CUDA port of vispec_tpu (greedy, batch-1, text-only ViSpec).

Module layout and function names follow ``vispec_tpu`` one to one; the JAX
package is the reference every module is tested against.  Entry points run on
the GPU (``device="cuda"``) unless the caller passes another device."""
