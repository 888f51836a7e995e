"""Multi-chain driver: ``ChainDriver``'s chunk paths and per-transition
path, for every sampler but the ensemble.

Counterpart of ``bayesfast_tpu/samplers/chain.py``. All chains advance
together. Two kinds of path:

* the NUTS chunk paths (``run_warmup_chunk``, ``run_frozen_chunk``,
  ``_CHUNK_CAP``, and the host threading of the Welford window ints,
  ``chain.py:443-518``): every chunk of up to ``_CHUNK_CAP`` transitions is
  one kernel launch (``nuts_cuda.py``), its adaptation inside the kernel;
* the per-transition path (``run``, ``chain.py:71-216`` and ``:520-530``):
  a Python loop over transitions, then the dual-averaging update and the
  pooled or per-chain Welford update as batched torch ops. A NUTS
  transition is one launch of the block kernel (or, for a full metric, a
  density without ``kernel_spec()`` or D > 256, one pass of the torch tree
  loop, ``nuts.py``; ``uses_kernels`` routes). HMC, THMC, TNUTS and
  ChEES transitions are plain torch on the chains' device (``hmc.py``,
  ``tempered.py``, ``chees.py``), as they are XLA in the JAX package; the
  tempered ones carry ``[u, q]`` and adapt the metric on ``q``; ChEES
  adapts one shared step size and trajectory length. The window
  decisions are host ints, so the loop reads nothing back from the device
  but ChEES's shared leapfrog count and the tree loop's end.

The carry holds one int32 seed in place of the JAX per-chain keys: the
kernels' randomness is keyed by (seed, global iteration, global chain), and
every torch transition's generator by (seed, global iteration), so the
seed never advances and chunk boundaries never change the stream.
"""

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from . import nuts_cuda
from . import nuts as _nuts
from .chees import chees_adapt_update, chees_transition_batched, halton2
from .hmc import hmc_transition
from .metrics import (DiagMetricState, _Welford, update_metric,
                      update_metric_pooled)
from .nuts import NutsStats
from .step_size import StepSizeState, current_step_size, update_step_size
from .tempered import thmc_transition, tnuts_transition_batched
from ..utils.random import generator_from_seed

__all__ = ['ChainCarry', 'ChainDriver']


class ChainCarry(NamedTuple):
    seed: int     # int32 kernel seed
    q: Any        # (n_chain, dim)
    step: Any     # StepSizeState, leaves (n_chain,); CheesAdaptState
    metric: Any   # Diag/FullMetricState, per-chain or pooled (shared)


_ALGORITHMS = ('nuts', 'hmc', 'thmc', 'tnuts', 'chees')


class ChainDriver:
    """Runs the transitions and their adaptation for one configuration.

    ``algorithm`` is 'nuts', 'hmc', 'thmc', 'tnuts' or 'chees'; the
    tempered ones need ``logp_and_grad_base``, the base density's ``(C,
    D) -> (logp, grad)`` in the sampling space. ``nuts_kernel`` (NUTS only)
    is 'auto' (the CUDA kernels on CUDA tensors, their plain torch versions
    on CPU tensors), 'cuda' (CPU tensors raise) or 'torch' (the plain
    versions on any device). ``pooled_metric`` adapts one metric from all
    chains' samples in ``run``.
    """

    # transitions per kernel launch, as in the JAX package
    _CHUNK_CAP = 64

    def __init__(self, density, algorithm='nuts', max_treedepth=10,
                 n_int_step=32, max_change=1000., target_accept=0.8,
                 gamma=0.05, k=0.75, t_0=10., adapt_step_size=True,
                 update_window=1, doubling=True, adapt_metric=True,
                 logp_and_grad_base=None, pooled_metric=False,
                 max_leapfrogs=1024, adapt_traj_len=True, chees_lr=0.025,
                 nuts_kernel='auto'):
        if nuts_kernel not in ('auto', 'cuda', 'torch'):
            raise ValueError("nuts_kernel should be 'auto', 'cuda' or "
                             "'torch'.")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f'unknown algorithm {algorithm}.')
        if algorithm in ('thmc', 'tnuts') and logp_and_grad_base is None:
            raise ValueError('tempered algorithms need logp_and_grad_base.')
        self._density = density
        self._algorithm = algorithm
        self._n_int_step = int(n_int_step)
        self._lpg_base = logp_and_grad_base
        self._max_leapfrogs = int(max_leapfrogs)
        self._adapt_traj_len = bool(adapt_traj_len)
        self._chees_lr = float(chees_lr)
        self._nuts_kernel = nuts_kernel
        self._max_treedepth = int(max_treedepth)
        self._max_change = float(max_change)
        self._target_accept = float(target_accept)
        self._gamma = float(gamma)
        self._k = float(k)
        self._t_0 = float(t_0)
        self._adapt_step_size = bool(adapt_step_size)
        self._update_window = int(update_window)
        self._doubling = bool(doubling)
        self._adapt_metric = bool(adapt_metric)
        self._pooled_metric = bool(pooled_metric)
        # NUTS matches its kernels' order of operations; the others have no
        # kernel to match, and take the fewest launches
        self._lpg = nuts_cuda.plain_lpg(density, algorithm == 'nuts')
        # uses_kernels' answer by D, and whether it has warned
        self._refusals, self._warned = {}, False

    def uses_kernels(self, metric):
        """Whether transitions under ``metric`` run on the NUTS kernels (or
        their plain versions) rather than the torch tree loop: NUTS with a
        diag metric, and a density the kernels take at the metric's D
        (``nuts_cuda.kernel_refusal``: a kernel spec, compiled in or
        traced from a logp or a ``Density`` plan, and D <= 256; a
        ``Density`` plan and the compiled-in banana name their own lower
        limits). Otherwise ``nuts_kernel='cuda'`` raises
        ``NotImplementedError`` here, before any device work, and 'auto'
        and 'torch' take the tree loop; under 'auto' a logp (or a logp and
        the user's gradient) that does not trace warns once, naming the op
        (as the JAX package warns when its kernel fails to lower); the
        tree loop then runs the user's gradient (``plain_lpg``)."""
        if (self._algorithm != 'nuts'
                or not isinstance(metric, DiagMetricState)):
            return False
        dim = int(metric.var.shape[-1])
        if dim not in self._refusals:
            self._refusals[dim] = nuts_cuda.kernel_refusal(
                self._density, dim, metric.var.dtype)
        why = self._refusals[dim]
        if why is None:
            return True
        if self._nuts_kernel == 'cuda':
            raise NotImplementedError(
                f"nuts_kernel='cuda': {why}; sample it on the tree loop "
                "(nuts_kernel='auto' or 'torch').")
        trace_error = getattr(self._density, 'kernel_trace_error',
                              lambda: None)()
        if (self._nuts_kernel == 'auto' and trace_error
                and not self._warned):
            self._warned = True
            warnings.warn(
                'the logp (with the user\'s gradient, where given; or the '
                'Density plan) does not trace into the CUDA NUTS kernels; '
                'its transitions run on the torch tree loop '
                f'(set_nuts_kernel controls this). Cause: {trace_error}',
                RuntimeWarning)
        return False

    @staticmethod
    def _generator(carry, it):
        """The torch transitions' generator of global iteration ``it``."""
        return generator_from_seed(
            np.random.SeedSequence([int(carry.seed), int(it)]),
            carry.q.device)

    def _batched_step(self, carry, warmup, i0, i):
        """One NUTS transition of every chain at global iteration ``i0 +
        i``; returns ``(q_new, NutsStats)``."""
        eps = current_step_size(carry.step, warmup)
        if not self.uses_kernels(carry.metric):
            gen = self._generator(carry, i0 + i)
            return _nuts.nuts_transition_batched(
                gen, carry.q, carry.metric, eps, self._lpg,
                self._max_treedepth, self._max_change)
        return nuts_cuda.nuts_transition_batched(
            nuts_cuda._transition_seed(carry.seed, i0, i), carry.q,
            carry.metric, eps, self._max_treedepth, self._max_change,
            density=self._density, lpg=self._lpg, kernel=self._nuts_kernel)

    def _torch_step(self, carry, warmup, it):
        """One HMC, THMC or TNUTS transition of every chain at global
        iteration ``it``; the tempered carry is ``[u, q]``. Returns
        ``(q_new, stats, accept_stat)``."""
        eps = current_step_size(carry.step, warmup)
        gen = self._generator(carry, it)
        if self._algorithm == 'hmc':
            q, st = hmc_transition(gen, carry.q, carry.metric, eps,
                                   self._lpg, self._n_int_step,
                                   self._max_change)
            return q, st, st.accept_stat
        u, qq = carry.q[:, 0], carry.q[:, 1:]
        if self._algorithm == 'thmc':
            q, u, st = thmc_transition(
                gen, qq, u, carry.metric, eps, self._lpg, self._lpg_base,
                self._n_int_step, self._max_change)
            accept = st.accept_stat
        else:
            q, u, st = tnuts_transition_batched(
                gen, qq, u, carry.metric, eps, self._lpg, self._lpg_base,
                self._max_treedepth, self._max_change)
            accept = st.mean_tree_accept
        return torch.cat([u[:, None], q], dim=1), st, accept

    def _chees_step(self, carry, warmup, it):
        """One ChEES transition of every chain at global iteration ``it``
        and the shared adaptation; returns ``(q_new, stats, adapt)``."""
        adapt = carry.step
        eps = current_step_size(adapt.step, warmup)
        h = halton2(adapt.count)
        q, st, (q_prop, v_prop, ap) = chees_transition_batched(
            self._generator(carry, it), carry.q, carry.metric, eps,
            torch.exp(adapt.log_T), h, self._lpg, self._max_leapfrogs,
            self._max_change)
        adapt = chees_adapt_update(
            adapt, carry.q, q_prop, v_prop, ap, h, eps, warmup,
            self._target_accept, self._gamma, self._k, self._t_0,
            self._adapt_step_size, self._adapt_traj_len, self._chees_lr,
            self._max_leapfrogs)
        return q, st, adapt

    def run(self, carry, warmup_flags, params=(), i0=0):
        """``len(warmup_flags)`` transitions, one at a time: transition
        ``i`` (global iteration ``i0 + i``) then the step-size update on its
        acceptance (NUTS, TNUTS: the mean tree acceptance) and the metric
        update (pooled or per chain) on its positions, each masked by its
        host flag. Returns ``(carry, (q (K, C, D), (stats, extras)))`` with
        (K, C) stat leaves, the stats of the algorithm's type; the extras'
        step sizes are recorded after the update. ``params`` is accepted
        for the JAX signature and unused."""
        qs, stats, extras = [], [], []
        tempered = self._algorithm in ('thmc', 'tnuts')
        for i, w in enumerate(warmup_flags):
            w = bool(w)
            if self._algorithm == 'chees':
                q, st, step = self._chees_step(carry, w, i0 + i)
                ss = step.step
            else:
                if self._algorithm == 'nuts':
                    q, st = self._batched_step(carry, w, i0, i)
                    accept = st.mean_tree_accept
                else:
                    q, st, accept = self._torch_step(carry, w, i0 + i)
                step = ss = update_step_size(
                    carry.step, accept, w, self._target_accept, self._gamma,
                    self._k, self._t_0, self._adapt_step_size)
            metric = carry.metric
            if self._adapt_metric:
                upd = (update_metric_pooled if self._pooled_metric
                       else update_metric)
                metric = upd(metric, q[:, 1:] if tempered else q, w,
                             self._update_window, self._doubling)
            carry = ChainCarry(carry.seed, q, step, metric)
            qs.append(q)
            stats.append(st)
            shape = st.logp.shape
            extras.append((torch.exp(ss.log_step).expand(shape),
                           torch.exp(ss.log_bar).expand(shape)))
        ss, ssb = (torch.stack(x) for x in zip(*extras))
        flags = torch.as_tensor(np.asarray(warmup_flags, bool),
                                device=ss.device)
        return carry, (torch.stack(qs), (
            type(stats[0])(*[torch.stack(x) for x in zip(*stats)]),
            {'step_size': ss, 'step_size_bar': ssb,
             'warmup': flags[:, None].expand(ss.shape)}))

    def _warmup_chunk(self, carry, n_steps, i0, wsched, ints_new):
        adapt = (self._max_treedepth, self._max_change, self._target_accept,
                 self._gamma, self._k, self._t_0, self._adapt_step_size,
                 self._adapt_metric, wsched)
        o = nuts_cuda.nuts_warmup_chunk_batched(
            carry.seed, carry.q, carry.step, carry.metric, n_steps, *adapt,
            density=self._density, lpg=self._lpg, i0=i0,
            kernel=self._nuts_kernel)
        extras = {'step_size': o['step_size'],
                  'step_size_bar': o['step_size_bar'],
                  'warmup': torch.ones_like(o['logp'], dtype=torch.bool)}
        step = StepSizeState(
            log_step=o['log_step'], log_bar=o['log_bar'], hbar=o['hbar'],
            count=o['count'], mu=carry.step.mu,
            # the post-warmup acceptance diagnostic stays untouched in warmup
            accept_sum=carry.step.accept_sum,
            accept_count=carry.step.accept_count)
        metric = DiagMetricState(
            var=o['var'], fg=_Welford(o['fg_mean'], o['fg_raw'], o['fg_w']),
            bg=_Welford(o['bg_mean'], o['bg_raw'], o['bg_w']),
            n_samples=ints_new[0], prev_update=ints_new[1],
            adapt_window=ints_new[2])
        new_carry = ChainCarry(carry.seed, o['q_final'], step, metric)
        stats = nuts_cuda._chunk_stats(o, carry.q.dtype)
        return new_carry, (o['q'], (stats, extras))

    def _frozen_chunk(self, carry, n_steps, i0):
        # frozen post-warmup step size: the dual-averaged one
        eps = torch.exp(carry.step.log_bar)
        q_chunk, q_last, stats = nuts_cuda.nuts_chunk_batched(
            carry.seed, carry.q, carry.metric, eps, n_steps,
            self._max_treedepth, self._max_change, density=self._density,
            lpg=self._lpg, i0=i0, kernel=self._nuts_kernel)
        # the only live adaptation state post-warmup is the acceptance
        # diagnostic accumulator
        step = carry.step._replace(
            accept_sum=carry.step.accept_sum
            + torch.sum(stats.mean_tree_accept, dim=0),
            accept_count=carry.step.accept_count + float(n_steps))
        new_carry = ChainCarry(carry.seed, q_last, step, carry.metric)
        return new_carry, (q_chunk, (stats, None))

    @staticmethod
    def _concat(pieces):
        if len(pieces) == 1:
            return pieces[0]
        qs = torch.cat([p[0] for p in pieces])
        stats = NutsStats(*[torch.cat(xs) for xs in
                            zip(*[p[1][0] for p in pieces])])
        extras = pieces[0][1][1]
        if extras is not None:
            extras = {k: torch.cat([p[1][1][k] for p in pieces])
                      for k in extras}
        return qs, (stats, extras)

    def run_warmup_chunk(self, carry, n_steps, params=(), i0=0,
                         win_ints=None):
        """``n_steps`` adapting transitions in launches of at most
        ``_CHUNK_CAP``. ``win_ints`` threads the (n_samples, prev_update,
        adapt_window) window counters across chunks host-side; None reads
        them from the carry. Returns ``(carry, out, win_ints)`` with
        ``out = (q (K, C, D), (NutsStats, extras))``. ``params`` is accepted
        for the JAX signature and unused."""
        n_steps = int(n_steps)
        if win_ints is None:
            m = carry.metric
            win_ints = (int(m.n_samples), int(m.prev_update),
                        int(m.adapt_window))
        pieces = []
        done = 0
        while done < n_steps:
            k = min(self._CHUNK_CAP, n_steps - done)
            wsched, win_ints = nuts_cuda._window_schedule(
                win_ints[0], win_ints[1], win_ints[2], k,
                self._update_window, self._doubling)
            carry, out = self._warmup_chunk(carry, k, i0 + done, wsched,
                                            win_ints)
            pieces.append(out)
            done += k
        return carry, self._concat(pieces), win_ints

    def run_frozen_chunk(self, carry, n_steps, params=(), i0=0):
        """``n_steps`` post-warmup transitions (step size and metric
        frozen) in launches of at most ``_CHUNK_CAP``. Returns
        ``(carry, out)``; the extras are None (the caller rebuilds the
        constant step-size rows)."""
        n_steps = int(n_steps)
        pieces = []
        done = 0
        while done < n_steps:
            k = min(self._CHUNK_CAP, n_steps - done)
            carry, out = self._frozen_chunk(carry, k, i0 + done)
            pieces.append(out)
            done += k
        return carry, self._concat(pieces)
