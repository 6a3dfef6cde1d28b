"""Checkpoint / resume for long-running solves.

The reference has no checkpointing (its solves are µs–ms scale;
SURVEY.md §5.4) — its closest analogues are the ``InitWith`` warm start
and the per-iteration history.  At accelerator batch scale a solve can run long
enough to be worth checkpointing, so this module exposes the segmented
loop execution (the same machinery as the ``max_duration_ms`` timeout
driver — both build on ``optimize._segment_pair``) as a public API plus
orbax persistence:

    solver = segment_solver(fn, options, x_example, iters_per_segment=10)
    x, out, st = solver.start(x0)           # first 10 iterations
    save_state(path, st)                    # ... process dies ...
    st = load_state(path, solver.abstract_state(x0))
    x, out, st = solver.resume(st)          # next 10, EXACT continuation

Resuming is bit-exact: the segment state is the complete loop carry
(λ schedule with compounded bad factors, accept/reject flags, failure
budgets, first-order optimizer state, Rebuild(false) flags), so N
segments of k iterations follow the identical trajectory to one N·k
iteration solve (the contract pinned by optimize._optimize_with_timeout
and tests/test_checkpoint.py).

``SegmentSolver.run`` honors the ORIGINAL ``options``: it stops after
``options.max_iters`` (+1 rollback slot) total iterations, applies the
``check_final_cost`` fallback, and aggregates iteration counts and
history across segments — same Output contract as ``to.optimize``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from . import manifold as mf
from .optimize import _segment_pair
from .options import Options
from .stop_reasons import StopReason


@dataclasses.dataclass
class SegmentSolver:
    """Jitted (start, resume) pair running ``iters_per_segment``
    iterations per call with full state continuity."""

    start: Callable     #: x0 -> (x, Output, state)
    resume: Callable    #: state -> (x, Output, state)
    options: Options    #: the ORIGINAL options (total budgets live here)
    _evaluate: Callable
    _x_example: Any
    _iters_per_segment: int = 10
    _tail_builder: Callable | None = None   # k -> (start, resume) @ k iters
    _tails: dict = dataclasses.field(default_factory=dict)

    def _sized(self, remaining: int):
        """(start, resume) executables sized to ``remaining`` iterations
        (cached per distinct remainder — one extra compile each)."""
        pair = self._tails.get(remaining)
        if pair is None:
            pair = self._tail_builder(remaining)
            self._tails[remaining] = pair
        return pair

    def abstract_state(self, x_example=None):
        """ShapeDtypeStruct pytree of the segment state — the restore
        template for :func:`load_state`."""
        x = mf.as_pytree(self._x_example if x_example is None
                         else x_example)
        return jax.eval_shape(self.start, x)[2]

    def run(self, x0, *, max_segments: int | None = None):
        """Drive segments until a terminal stop reason or the original
        options' total iteration budget (``max_iters`` + 1 rollback slot,
        + 1 with ``check_final_cost`` — the same allowance as the
        unchunked loop).  Aggregates ``num_iters`` and history across
        segments and applies the ``check_final_cost`` fallback.  Returns
        ``(x, Output, state)``."""
        import numpy as np

        budget = self.options.max_iters + 1 \
            + (1 if self.options.check_final_cost else 0)
        x0 = mf.as_pytree(x0)
        total = 0
        n_seg = 0
        hist_e, hist_d, hist_s = [], [], []
        st = None
        while True:
            remaining = budget - total
            # Exact-budget sizing applies to EVERY segment including the
            # first: with a small budget (max_iters + allowances <
            # iters_per_segment) an unsized start would run and report
            # more iterations than the original options permit.
            undersized = (remaining < self._iters_per_segment
                          and self._tail_builder is not None)
            if st is None:
                start = (self._sized(remaining)[0] if undersized
                         else self.start)
                x, out, st = start(x0)
            elif undersized:
                # Exact-budget tail: a resume executable sized to the
                # remainder, so the total NEVER overshoots max_iters + 1
                # (one extra compile per distinct remainder, cached).
                x, out, st = self._sized(remaining)[1](st)
            else:
                x, out, st = self.resume(st)
            total += int(out.num_iters)
            n_seg += 1
            if self.options.save_history:
                n = int(out.num_hist)
                hist_e += list(np.asarray(out.errs[:n]))
                hist_d += list(np.asarray(out.deltas2[:n]))
                hist_s += list(np.asarray(out.successes[:n]))
            if int(out.stop_reason) not in (int(StopReason.MAX_ITERS),
                                            int(StopReason.NONE)):
                break
            if total >= budget:
                break
            if max_segments is not None and n_seg >= max_segments:
                break

        # Non-terminal exit: x carries the last segment's applied-but-
        # unevaluated proposal (segment continuation needs every iteration
        # applied); the unchunked loop's gated final apply makes its
        # returned x the best accepted point — st.best_x holds exactly
        # that, bit-for-bit (mirrors optimize._optimize_with_timeout and
        # subsumes check_final_cost, options.h:43).
        if int(out.stop_reason) in (int(StopReason.MAX_ITERS),
                                    int(StopReason.NONE)):
            x = st.best_x

        out.num_iters = jnp.asarray(total, jnp.int32)
        if self.options.save_history:
            dt = np.asarray(out.errs).dtype
            out.errs = jnp.asarray(np.asarray(hist_e, dt)
                                   if hist_e else np.zeros((0,), dt))
            out.deltas2 = jnp.asarray(np.asarray(hist_d, dt)
                                      if hist_d else np.zeros((0,), dt))
            out.successes = jnp.asarray(np.asarray(hist_s, bool)
                                        if hist_s else np.zeros((0,), bool))
            out.num_hist = jnp.asarray(len(hist_e), jnp.int32)
        return x, out, st


@dataclasses.dataclass
class Stepper:
    """Imperative one-iteration-at-a-time interface.

    The public equivalent of the reference's ``Optimizer_::Step``
    (reference: include/tinyopt/optimizers/optimizer.h:332): each
    :meth:`step` call runs EXACTLY one loop iteration — build (or
    evaluate-only after a rejection), solve-retry with λ escalation,
    accept/reject/rollback, budgets and the stop cascade — and hands the
    complete loop state back, so a user can drive arbitrary outer logic
    (custom schedules, per-iteration telemetry, interleaved solves)
    between iterations.  N ``step`` calls follow the identical trajectory
    to one ``optimize`` call with ``max_iters=N`` (the segment-continuity
    contract, tests/test_checkpoint.py).

    Usage::

        st = to.stepper(fn, options, x_example=x0)
        x, out, state = st.step(x0)          # iteration 0
        while int(out.stop_reason) in (int(to.StopReason.NONE),
                                       int(to.StopReason.MAX_ITERS)):
            x, out, state = st.step(state=state)
        x = st.best_x(state)                 # last ACCEPTED parameters

    ``out.stop_reason`` is ``MAX_ITERS`` while the single-iteration budget
    is the only thing stopping the loop — i.e. "keep going"; any other
    reason is the solve's verdict.  The ``x`` returned mid-run carries the
    applied-but-unevaluated proposal (the next step evaluates it);
    :meth:`best_x` is the best evaluated point, matching what
    ``to.optimize`` would return if stopped there.
    """

    _seg: "SegmentSolver"

    def step(self, x0=None, state=None):
        """Run one iteration. Pass ``x0`` for the first call, ``state``
        (from the previous call) afterwards.  Returns ``(x, Output,
        state)``."""
        if (x0 is None) == (state is None):
            raise ValueError("pass exactly one of x0 (first call) or "
                             "state (subsequent calls)")
        if state is None:
            return self._seg.start(mf.as_pytree(x0))
        return self._seg.resume(state)

    def best_x(self, state):
        """Best accepted parameters in ``state`` (what ``to.optimize``
        returns: never an unevaluated trailing proposal)."""
        return state.best_x

    def evaluate(self, x):
        """Normalized cost at ``x`` (the loop's evaluate-only branch)."""
        return self._seg._evaluate(mf.as_pytree(x))


def stepper(fn: Callable, options: Options | None = None,
            x_example=None, *, mode: str = "auto") -> Stepper:
    """Build a :class:`Stepper` — the imperative single-``Step()`` API."""
    return Stepper(_seg=segment_solver(fn, options, x_example, mode=mode,
                                       iters_per_segment=1))


def segment_solver(fn: Callable, options: Options | None = None,
                   x_example=None, *, mode: str = "auto",
                   iters_per_segment: int = 10) -> SegmentSolver:
    """Build a resumable solver running ``iters_per_segment`` loop
    iterations per device dispatch (see module docstring)."""
    options = options or Options()
    if x_example is None:
        raise ValueError("segment_solver requires x_example")
    x_example = mf.as_pytree(x_example)
    start, resume, evaluate, _spec, _ndu, mode, _n_res = _segment_pair(
        fn, options, mode, x_example, iters_per_segment)

    def tail_builder(k: int):
        return _segment_pair(fn, options, mode, x_example, k)[:2]

    return SegmentSolver(start=start, resume=resume, options=options,
                         _evaluate=evaluate, _x_example=x_example,
                         _iters_per_segment=iters_per_segment,
                         _tail_builder=tail_builder)


def save_state(path: str, state) -> None:
    """Persist a segment state (or any array pytree) with orbax."""
    import os

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, jax.tree_util.tree_map(jnp.asarray, state),
               force=True)
    ckptr.wait_until_finished()


def load_state(path: str, abstract_state):
    """Restore a segment state saved by :func:`save_state`.

    ``abstract_state`` is the template from
    :meth:`SegmentSolver.abstract_state` (orbax needs the pytree
    structure and shapes/dtypes to restore into).
    """
    import os

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, abstract_state)
