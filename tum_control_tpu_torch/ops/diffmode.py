"""Reverse mode through the hand-written kernels (the port's counterpart of
tum_control_tpu/ops/diffmode.py).

The CUDA kernels (ops/kernels/) compute values only. On the card every
kernel wrapper launches its kernel through `kernel_with_plain_vjp`: a
`torch.autograd.Function` whose forward is the kernel and whose backward
recomputes the kernel's plain PyTorch version at the saved inputs and takes
its vector-Jacobian product (`torch.func.vjp`). `torch.autograd` then runs
through whole closed-loop steps with the kernels in the forward, tire
parameters given as 0-d tensors included (closed-loop parameter
identification, as tools/fit_tires_closedloop.py does with the JAX
package). No switch is needed: the JAX package's TUM_DIFFERENTIABLE=1,
which routes every kernel to its plain form, has no counterpart here. On
the CPU the wrappers run the plain versions, which autograd follows
directly.

The plain versions are written so that reverse mode runs through them: K1's
`torch.func.jacfwd`, the out-of-place Cholesky and substitution loops, the
condensing stage loops and the Mehrotra iteration.
"""
from __future__ import annotations

import torch


def _as_tuple(outs):
    return outs if isinstance(outs, tuple) else (outs,)


class _KernelWithPlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        outs = kernel(*inputs)
        flat = _as_tuple(outs)
        ctx.plain = plain
        ctx.float_outputs = [i for i, o in enumerate(flat) if o.is_floating_point()]
        ctx.save_for_backward(*inputs)
        ctx.mark_non_differentiable(*(o for o in flat if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        keep = ctx.float_outputs

        def plain_float(*args):
            flat = _as_tuple(ctx.plain(*args))
            return tuple(flat[i] for i in keep)

        _, vjp_fn = torch.func.vjp(plain_float, *ctx.saved_tensors)
        return (None, None, *vjp_fn(tuple(grads[i] for i in keep)))


def kernel_with_plain_vjp(kernel, plain, *inputs):
    """`kernel(*inputs)`, a tensor or a flat tuple of tensors, with the
    backward of `plain(*inputs)`, the same function in plain PyTorch.
    `inputs` are tensors; other arguments are bound into both callables.
    Outputs that are not floating point (masks) carry no gradient."""
    return _KernelWithPlainVJP.apply(kernel, plain, *inputs)
