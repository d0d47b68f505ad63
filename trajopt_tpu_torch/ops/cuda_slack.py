"""`slack_step`: the slack phase of the ADMM step in one CUDA launch.

The kernel (``csrc/slack.cu``) replaces no TPU kernel: it fuses what the
JAX package leaves to XLA in `trajopt_tpu/solver/admm.py::slack_update`
(the converted spline, the slack energy's gradient and Hessian, the freeze
mask, the GMW-repaired Newton solve by K3 and K4's device code, the
steepest-descent fallback, the step clamp, the Armijo ladder, the dual
ascent and the residual), which in PyTorch is a chain of small kernels and
a conditional graph node an iteration.  Its Hessian is the closed form for
``grad_mode="analytic"`` and its repair GMW, so `solver.admm.slack_update`
launches it for a CUDA state under ``psd_method="gmw"`` and
``grad_mode="analytic"`` and takes the plain version,
`solver.admm.slack_update_plain`, in every other case.  On the card the
kernel is latency-bound: one block a robot, one warp a piece, the ladder
32 rungs a pass (the note in ``csrc/slack.cu``).
"""

from __future__ import annotations

import torch

from ..config import TrajOptConfig
from ..types import SolverState, SplineConsts
from . import _cuda
from .cuda_chol import _gmw_scale
from .gradients import N_CP, N_LOC


def slack_step(
    consts: SplineConsts, cfg: TrajOptConfig, state: SolverState
) -> tuple[SolverState, torch.Tensor, torch.Tensor]:
    """One launch of the slack phase for a state with any leading robot axes:
    (new state, consensus residual [robots...], accepted rung [robots...,
    P] int32).  Takes contiguous float32 CUDA tensors only and raises on any
    other (no plain fallback: the caller picks the path)."""
    tensors = (state.spline, state.piece_time, state.p_slack, state.t_slack, state.p_lambda,
               state.t_lambda, consts.convert, consts.m_dyn)
    if any(t.device.type == "cpu" for t in tensors):
        raise ValueError("slack_step runs on the card; on the CPU take "
                         "solver.admm.slack_update_plain")
    _cuda.require_cuda_f32("slack_step", *tensors)
    lead = state.spline.shape[:-2]
    pieces = consts.piece_num
    idx = consts.piece_idx
    if (state.p_slack.shape != lead + (pieces, N_CP, 3) or state.t_slack.shape != lead + (pieces,)
            or state.piece_time.shape != lead or consts.m_dyn.shape != (N_CP, N_CP)
            or consts.convert.shape != (pieces, N_CP, N_CP) or idx.shape != (pieces, N_CP)
            or state.p_lambda.shape != state.p_slack.shape
            or state.t_lambda.shape != state.t_slack.shape):
        raise ValueError(f"slack_step: a state of {pieces} pieces of {N_CP} control points "
                         f"does not match {tuple(state.p_slack.shape)}")
    if idx.dtype != torch.int64 or idx.device != state.spline.device or not idx.is_contiguous():
        raise ValueError("slack_step: piece_idx must be a contiguous int64 tensor on the "
                         "state's device")
    robots = state.t_slack.numel() // pieces
    p_slack, t_slack = torch.empty_like(state.p_slack), torch.empty_like(state.t_slack)
    p_lambda, t_lambda = torch.empty_like(state.p_lambda), torch.empty_like(state.t_lambda)
    residual = torch.empty(lead, dtype=state.spline.dtype, device=state.spline.device)
    rungs = torch.empty(state.t_slack.shape, dtype=torch.int32, device=state.spline.device)
    err = _cuda.lib().trajopt_slack_step(
        state.spline.data_ptr(), state.spline.shape[-2], idx.data_ptr(), consts.convert.data_ptr(),
        consts.m_dyn.data_ptr(), state.piece_time.data_ptr(), state.p_slack.data_ptr(),
        state.t_slack.data_ptr(), state.p_lambda.data_ptr(), state.t_lambda.data_ptr(),
        p_slack.data_ptr(), t_slack.data_ptr(), p_lambda.data_ptr(), t_lambda.data_ptr(),
        residual.data_ptr(), rungs.data_ptr(), robots, pieces, cfg.max_line_search, cfg.ks,
        cfg.kt, cfg.mu, cfg.mu / 2.0, 2 * cfg.der - 1, _gmw_scale(N_LOC), _cuda.stream(),
    )
    _cuda.check_launch(err, "slack_step", (state.p_slack.shape, "rungs", cfg.max_line_search))
    new_state = state._replace(p_slack=p_slack, t_slack=t_slack, p_lambda=p_lambda,
                               t_lambda=t_lambda)
    return new_state, residual, rungs
