"""The benchmark's plain reference: the solver worked out again, from the
same request inputs, in plain PyTorch.

A frozen copy of `trajopt_tpu_torch` as of commit 35ea473, so that a later
change to the program cannot move its own yardstick.  Each module is that
package's module of the same name (`config`, `types`, `metrics`, and under
`ops/` and `solver/` the rest) with its imports pointed here, and nothing
else changed, except:

- `kernels`: the plain versions of the hand-written kernels K1-K4 and K6
  (the functions each `ops/cuda_*.py` wrapper takes for a CPU tensor),
  whatever device the tensors are on;
- `branch`: `device_cond` and `fixed_rounds` in their branch form (a
  Python branch on a host read), the form the program takes on the CPU;
- `solve`: the fused drivers' loop and stop rule as a host loop.

It imports nothing of `trajopt_tpu_torch` and nothing of JAX.
"""
