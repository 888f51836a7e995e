"""Multi-phase surrogate workflow driver.

Counterpart of ``bayesfast_tpu/core/recipe.py``: optimize a surrogate to
the MAP neighbourhood with Laplace passes, alternate surrogate refits with
NUTS runs, then importance-correct and estimate the evidence. Every true-
model evaluation of a phase is one batched ``density.fun(x)`` (torch on the
device for traceable modules, the host pool of ``utils.parallel`` for
external ones), and every surrogate sample step runs all its chains
together through ``sample``: on the CUDA NUTS chunk kernels when the
surrogate density is compiled in (``Density.kernel_spec``), else on the
torch tree loop.
"""

from collections import namedtuple
from copy import deepcopy
import warnings

import numpy as np
from scipy.special import logsumexp

import torch

from ..config import get_device
from .module import Surrogate
from .density import DensityLite
from .pipeline import Density
from .sample import sample
from ..samplers.sample_trace import (SampleTrace, NTrace, TraceTuple,
                                     _HTrace, _get_step_size, _get_metric)
from ..utils import all_isinstance, Laplace, SystematicResampler
from ..utils.acor import integrated_time
from ..utils.collections import PropertyList
from ..utils.sobol import multivariate_normal

__all__ = ['OptimizeStep', 'SampleStep', 'PostStep', 'StaticSample',
           'DynamicSample', 'RecipeTrace', 'Recipe']


# ---------------------------------------------------------------------------
# config coercion helpers — dicts promote to config objects everywhere, the
# same convention the reference applies via validating setters
# ---------------------------------------------------------------------------

def _promote(spec, cls, what):
    """None -> cls(), dict -> cls(**dict), cls instance passes through."""
    if spec is None:
        return cls()
    if isinstance(spec, dict):
        return cls(**spec)
    if isinstance(spec, cls):
        return spec
    raise ValueError(f'cannot interpret {what}: expected None, a dict or a '
                     f'{cls.__name__}, got {type(spec).__name__}.')


def _check_surrogates(items):
    for k, s in enumerate(items):
        if not isinstance(s, Surrogate):
            raise ValueError(f'surrogate_list[{k}] is a '
                             f'{type(s).__name__}, not a Surrogate.')
    return items


def _surrogate_tuple(sl):
    """Validated PropertyList of Surrogates (single instance allowed); its
    check is a module-level function, so a checkpoint can pickle it."""
    if isinstance(sl, Surrogate):
        sl = [sl]
    return PropertyList(sl, _check_surrogates)


def _float64_call(fn, x):
    """A torch density function of one point, at host x, in float64."""
    with torch.no_grad():
        return float(fn(torch.as_tensor(np.asarray(x, np.float64),
                                        dtype=torch.float64,
                                        device=get_device())))


def _stack_logp(vds, density_name):
    """Collect the named logp output across an array of VariableDicts."""
    return np.concatenate([np.atleast_1d(vd.fun[density_name]) for vd in vds])


# ---------------------------------------------------------------------------
# phase configs
# ---------------------------------------------------------------------------

class _StepConfig:
    """Options shared by the optimize and sample phases
    (reference ``recipe.py:35-132``)."""

    def __init__(self, surrogate_list=(), alpha_n=2., fitted=False,
                 sample_trace=None, x_0=None, reuse_metric=True):
        self._surrogate_list = _surrogate_tuple(surrogate_list)
        self._alpha_n = float(alpha_n)
        self._fitted = bool(fitted)
        self._x_0 = None if x_0 is None else np.atleast_2d(x_0).copy()
        self.reuse_metric = bool(reuse_metric)
        if sample_trace is None or isinstance(sample_trace, dict):
            sample_trace = NTrace(**(sample_trace or {}))
        elif not isinstance(sample_trace, (SampleTrace, TraceTuple)):
            raise ValueError('sample_trace should be None, a dict, a '
                             'SampleTrace or a TraceTuple.')
        self._sample_trace = sample_trace

    surrogate_list = property(lambda self: self._surrogate_list)
    alpha_n = property(lambda self: self._alpha_n)
    fitted = property(lambda self: self._fitted)
    x_0 = property(lambda self: self._x_0)
    sample_trace = property(lambda self: self._sample_trace)

    @property
    def n_surrogate(self):
        return len(self._surrogate_list)

    @property
    def has_surrogate(self):
        return self.n_surrogate > 0

    @property
    def n_eval(self):
        """Fit-point budget: alpha_n x the largest surrogate's n_param."""
        return int(self._alpha_n *
                   max(su.n_param for su in self._surrogate_list))


class OptimizeStep(_StepConfig):
    """Config for the optimization phase (reference ``recipe.py:135-251``):
    iterated surrogate refits around Laplace MAP estimates."""

    def __init__(self, surrogate_list=(), alpha_n=2., laplace=None,
                 eps_pp=0.1, eps_pq=0.1, max_iter=5, x_0=None, fitted=False,
                 run_sampling=True, sample_trace=None, reuse_metric=True):
        super().__init__(surrogate_list, alpha_n, fitted, sample_trace, x_0,
                         reuse_metric)
        if laplace is None:
            laplace = Laplace(beta=100.)
        self.laplace = _promote(laplace, Laplace, 'laplace')
        self.eps_pp = float(eps_pp)
        self.eps_pq = float(eps_pq)
        self.max_iter = int(max_iter)
        self.run_sampling = bool(run_sampling)
        if min(self.eps_pp, self.eps_pq) <= 0 or self.max_iter <= 0:
            raise ValueError('eps_pp, eps_pq and max_iter must all be '
                             'positive.')


class SampleStep(_StepConfig):
    """Config for one refit-and-sample round (reference
    ``recipe.py:254-405``)."""

    def __init__(self, surrogate_list=(), alpha_n=2., sample_trace=None,
                 resampler=None, reuse_samples=0, reuse_step_size=True,
                 reuse_metric=True, logp_cutoff=True, alpha_min=0.75,
                 alpha_supp=1.25, x_0=None, fitted=False):
        super().__init__(surrogate_list, alpha_n, fitted, sample_trace, x_0,
                         reuse_metric)
        if resampler is None or isinstance(resampler, dict):
            resampler = SystematicResampler(**(resampler or {}))
        elif not callable(resampler):
            raise ValueError('resampler should be None, a dict of '
                             'SystematicResampler options, or a callable.')
        self.resampler = resampler
        self.reuse_samples = int(reuse_samples)
        self.reuse_step_size = bool(reuse_step_size)
        self.logp_cutoff = bool(logp_cutoff)
        self.alpha_min = float(alpha_min)
        self.alpha_supp = float(alpha_supp)
        if not 0 < self.alpha_min <= 1:
            raise ValueError('alpha_min should lie in (0, 1].')
        if self.alpha_supp <= 0:
            raise ValueError('alpha_supp should be positive.')

    @property
    def n_eval_min(self):
        return int(self.alpha_min * self.n_eval)


class PostStep:
    """Config for the post phase (reference ``recipe.py:408-473``):
    importance reweighting plus optional evidence estimation."""

    def __init__(self, n_is=0, k_trunc=0.25, evidence_method=None):
        self.n_is = int(n_is)
        self.k_trunc = float(k_trunc)
        self.evidence_method = self._resolve_evidence(evidence_method)

    @staticmethod
    def _resolve_evidence(em):
        if em is None:
            return None
        if isinstance(em, str) or isinstance(em, dict):
            from ..evidence import GBS, GIS, GHM
            table = {'GBS': GBS, 'GIS': GIS, 'GHM': GHM}
            if isinstance(em, dict):
                return GBS(**em)
            if em in table:
                return table[em]()
            raise ValueError(f'unknown evidence method name {em!r}; choose '
                             'from GBS / GIS / GHM or pass a callable.')
        if hasattr(em, 'run') or callable(em):
            return em
        raise ValueError('evidence_method should be a name, an options dict, '
                         'an estimator object or a callable.')


# ---------------------------------------------------------------------------
# sample-phase scheduling strategies
# ---------------------------------------------------------------------------

class _SampleStrategy:
    """Decides which SampleStep (if any) runs next, given the results so
    far (reference ``recipe.py:476-486``)."""

    def __init__(self):
        self._i = 0

    def update(self, sample_results):
        raise NotImplementedError('abstract method.')

    @property
    def n_step(self):
        raise NotImplementedError('abstract property.')


class StaticSample(_SampleStrategy):
    """Run a predetermined list of SampleSteps, each optionally repeated
    (reference ``recipe.py:489-568``)."""

    def __init__(self, sample_steps=None, repeat=None, verbose=True):
        super().__init__()
        if repeat is not None:
            sample_steps = self._expand_repeat(sample_steps, repeat)
        self._sample_steps = self._coerce_steps(sample_steps)
        self.verbose = bool(verbose)

    @staticmethod
    def _expand_repeat(steps, repeat):
        if not hasattr(steps, '__iter__'):
            warnings.warn('repeat only applies when sample_steps is a '
                          'sequence; dropping it.', RuntimeWarning)
            return steps
        try:
            return [s for k, s in enumerate(steps) for _ in range(repeat[k])]
        except Exception:
            warnings.warn('could not apply the repeat counts to '
                          'sample_steps; dropping repeat.', RuntimeWarning)
            return steps

    @staticmethod
    def _coerce_steps(steps):
        if steps is None:
            return ()
        if isinstance(steps, (SampleStep, dict)):
            steps = [steps]
        elif not (all_isinstance(steps, (SampleStep, dict)) and
                  len(steps) > 0):
            raise ValueError('sample_steps should be a SampleStep, an '
                             'options dict, or a non-empty sequence of '
                             'those.')
        return tuple(SampleStep(**deepcopy(s)) if isinstance(s, dict)
                     else deepcopy(s) for s in steps)

    @property
    def sample_steps(self):
        return self._sample_steps

    @property
    def n_step(self):
        return len(self._sample_steps)

    def update(self, sample_results):
        k = len(sample_results)
        if k < self.n_step:
            if self.verbose:
                print(f'\n *** StaticSample: scheduling SampleStep #{k} of '
                      f'{self.n_step}. *** \n')
            return deepcopy(self._sample_steps[k])
        if self.verbose:
            print(f'\n *** StaticSample: all {self.n_step} SampleStep(s) '
                  'consumed; sample phase complete. *** \n')
        return None


class DynamicSample(_SampleStrategy):
    """Adaptive scheduling; unimplemented in the reference as well
    (``recipe.py:571-574``)."""

    def __init__(self, *args):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# result records (field names are part of the public API)
# ---------------------------------------------------------------------------

RecipePhases = namedtuple('RecipePhases', 'optimize, sample, post')

PointDoublet = namedtuple('PointDoublet', 'x, x_trans')

DensityQuartet = namedtuple('DensityQuartet',
                            'logp, logq, logp_trans, logq_trans')

OptimizeResult = namedtuple('OptimizeResult', 'x_max, f_max, surrogate_list, '
                            'var_dicts, laplace_samples, laplace_result, '
                            'samples, sample_trace')

SampleResult = namedtuple('SampleResult', 'samples, surrogate_list, '
                          'var_dicts, sample_trace')

PostResult = namedtuple('PostResult', 'samples, weights, weights_trunc, logp, '
                        'logq, logz, logz_err, x_p, x_q, logp_p, logq_q, '
                        'trace_p, trace_q, n_call, x_max, f_max')


# ---------------------------------------------------------------------------
# phase bookkeeping
# ---------------------------------------------------------------------------

class RecipeTrace:
    """Records the configured steps, the accumulated results, and how far
    each phase has progressed (reference ``recipe.py:580-692``). A Recipe
    resumes by rerunning only the unfinished phases."""

    def __init__(self, optimize=None, sample=None, post=None,
                 sample_repeat=None):
        if optimize is None or isinstance(optimize, OptimizeStep):
            self._s_optimize = deepcopy(optimize)
        elif isinstance(optimize, dict):
            self._s_optimize = OptimizeStep(**deepcopy(optimize))
        else:
            raise ValueError('optimize should be None, a dict or an '
                             'OptimizeStep.')

        if isinstance(sample, _SampleStrategy):
            self._strategy = sample
        else:
            self._strategy = StaticSample(sample, sample_repeat)
        self._s_sample = []

        # post=None still builds a default PostStep (reference convention:
        # the post phase always runs unless explicitly disabled downstream)
        self._s_post = _promote({} if post is None else post, PostStep,
                                'post')

        self._r_optimize = []
        self._r_sample = []
        self._r_post = None
        self._i_optimize = 0
        self._i_sample = 0
        self._i_post = 0

    @property
    def results(self):
        return RecipePhases(tuple(self._r_optimize), tuple(self._r_sample),
                            self._r_post)

    @property
    def steps(self):
        return RecipePhases(self._s_optimize, tuple(self._s_sample),
                            self._s_post)

    @property
    def sample_strategy(self):
        return self._strategy

    @property
    def i(self):
        """Completed units per phase."""
        return RecipePhases(self._i_optimize, self._i_sample, self._i_post)

    @property
    def n(self):
        """Planned units per phase."""
        return RecipePhases(0 if self._s_optimize is None else 1,
                            self._strategy.n_step,
                            0 if self._s_post is None else 1)

    @property
    def finished(self):
        n = self.n
        return RecipePhases(self._i_optimize == n.optimize,
                            self._i_sample == n.sample,
                            self._i_post == n.post)

    @property
    def n_call(self):
        """Cumulative true-model evaluations (reference
        ``recipe.py:665-682``). For surrogate steps this is the number of
        fit points; for surrogate-free steps the true model is called inside
        the MCMC itself, so the exact per-iteration tally kept by the trace
        (tree sizes / leapfrog counts, see ``samplers/sample_trace.py``) is
        used — the reference raises NotImplementedError there because its
        traces lack the accounting."""
        if self._r_post is not None:
            return self._r_post.n_call
        total = 0
        for res in (*self._r_optimize, *self._r_sample):
            if len(res.surrogate_list) > 0 and res.var_dicts is not None:
                total += len(res.var_dicts)
            elif res.sample_trace is not None:
                total += int(res.sample_trace.n_call)
            else:
                raise NotImplementedError(
                    'step has neither surrogate fit points nor a sample '
                    'trace to account calls from.')
        return total


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class Recipe:
    """End-to-end surrogate workflow (reference ``recipe.py:717-1367``):
    optimize -> sample round(s) -> post."""

    def __init__(self, density, parallel_backend=None, recipe_trace=None,
                 optimize=None, sample=None, post=None, sample_repeat=None,
                 copy_density=True):
        if not isinstance(density, (Density, DensityLite)):
            raise ValueError('density should be a Density or DensityLite.')
        self._density = deepcopy(density) if copy_density else density
        # accepted for reference API compatibility; external true models
        # fan out over the global pool (utils.parallel.set_backend)
        self._parallel_backend = parallel_backend

        if recipe_trace is None:
            recipe_trace = RecipeTrace(optimize, sample, post, sample_repeat)
        elif isinstance(recipe_trace, dict):
            recipe_trace = RecipeTrace(**recipe_trace)
        elif not isinstance(recipe_trace, RecipeTrace):
            raise ValueError('recipe_trace should be None, a dict or a '
                             'RecipeTrace.')
        self._trace = recipe_trace

    @property
    def density(self):
        return self._density

    @property
    def recipe_trace(self):
        return self._trace

    # -- true-model evaluation (batched; device or thread-pooled host) -----

    def _eval_true(self, x):
        """Evaluate the true (un-surrogated) model at a batch of points.
        Plays the role of the reference's pool map (``recipe.py:867-868``)."""
        vds = self.density.fun(np.asarray(x), original_space=True,
                               use_surrogate=False)
        return np.atleast_1d(vds)

    def _true_logp(self, x):
        return self.density.logp(x, original_space=True, use_surrogate=False)

    def _surro_logp(self, x):
        return self.density.logp(x, original_space=True, use_surrogate=True)

    # ------------------------- optimize phase -----------------------------

    def _laplace_pass(self, step, x_0, var_dicts):
        """One Laplace pass on the current surrogate; records an
        OptimizeResult (reference ``recipe.py:799-827``)."""
        den = self.density
        traceable = den.device_logp(original_space=False, use_surrogate=True)
        lap_res = step.laplace.run(
            logp=lambda x: _float64_call(traceable, x),
            x_0=den.from_original(x_0[0]), traceable=traceable)

        x_trans = lap_res.x_max
        x = den.to_original(x_trans)
        logp = den.logp(x, original_space=True, use_surrogate=False)
        logp_trans = den.from_original_density(density=logp, x=x)
        logq_trans = lap_res.f_max
        logq = den.to_original_density(density=logq_trans, x=x)

        self._trace._r_optimize.append(OptimizeResult(
            x_max=PointDoublet(x, x_trans),
            f_max=DensityQuartet(float(logp), float(logq),
                                 float(logp_trans), float(logq_trans)),
            surrogate_list=deepcopy(list(den._surrogate_list)),
            var_dicts=var_dicts,
            laplace_samples=den.to_original(lap_res.samples),
            laplace_result=lap_res, samples=None, sample_trace=None))

    def _initial_fit_points(self, step):
        """Fit points for optimize iteration #0 (reference
        ``recipe.py:845-864``)."""
        if step.x_0 is None:
            dim = self.density.input_size
            return multivariate_normal(np.zeros(dim), np.eye(dim),
                                       step.n_eval)
        if step.n_eval <= 0:
            return step.x_0.copy()
        if step.x_0.shape[0] < step.n_eval:
            raise RuntimeError(
                f'the surrogate fit wants n_eval = {step.n_eval} points but '
                f'x_0 supplies only {step.x_0.shape[0]}.')
        return step.x_0[:step.n_eval].copy()

    def _select_best_pass(self, results, verbose):
        """Keep the Laplace pass with the highest logp_trans, breaking ties
        by the smallest |logp_trans - logq_trans| (reference
        ``recipe.py:908-920``)."""
        lp = np.asarray([r.f_max.logp_trans for r in results])
        best = np.where(lp == lp.max())[0]
        if best.size > 1:
            lq = np.asarray([r.f_max.logq_trans for r in results])
            best = best[np.argmin(np.abs(lp - lq)[best])]
        else:
            best = best[0]
        results.append(results[best])
        if verbose:
            print(f' OptimizeStep: keeping pass #{best} (highest '
                  'logp_trans).\n')

    def _opt_step(self, verbose=True):
        step = self._trace._s_optimize
        results = self._trace._r_optimize

        if step.has_surrogate:
            if isinstance(self._density, DensityLite):
                raise RuntimeError('surrogate fitting needs a Density (a '
                                   'module pipeline); DensityLite has no '
                                   'fit targets.')
            self._density.surrogate_list = list(step.surrogate_list)

            if step.fitted:
                x_0 = (np.zeros(self.density.input_size) if step.x_0 is None
                       else step.x_0.copy())
                var_dicts = None
            else:
                x_0 = self._initial_fit_points(step)
                var_dicts = self._eval_true(x_0)
                self.density.fit(var_dicts)
            self._laplace_pass(step, x_0, var_dicts)
            f = results[-1].f_max
            if verbose:
                print(' OptimizeStep: pass #0 done; logp = '
                      f'{f.logp:.3f}, logp_trans = {f.logp_trans:.3f}, '
                      f'delta_pq = {f.logp_trans - f.logq_trans:.3f}.')

            for k in range(1, step.max_iter):
                if step.n_eval <= 0:
                    raise RuntimeError('iterated refits (max_iter > 1) need '
                                       'a positive n_eval, i.e. a positive '
                                       'alpha_n.')
                x_0 = results[-1].laplace_samples
                if x_0.shape[0] < step.n_eval:
                    raise RuntimeError(
                        f'the refit wants n_eval = {step.n_eval} points but '
                        f'the previous Laplace pass produced only '
                        f'{x_0.shape[0]}.')
                x_0 = x_0[:step.n_eval].copy()
                var_dicts = self._eval_true(x_0)
                self.density.fit(var_dicts)
                self._laplace_pass(step, x_0, var_dicts)
                f, f_prev = results[-1].f_max, results[-2].f_max
                d_pp = f.logp_trans - f_prev.logp_trans
                d_pq = f.logp_trans - f.logq_trans
                if verbose:
                    print(f' OptimizeStep: pass #{k} done; logp = '
                          f'{f.logp:.3f}, logp_trans = {f.logp_trans:.3f}, '
                          f'delta_pp = {d_pp:.3f}, delta_pq = {d_pq:.3f}.')
                if abs(d_pp) < step.eps_pp and abs(d_pq) < step.eps_pq:
                    break
                if k == step.max_iter - 1:
                    warnings.warn('OptimizeStep hit max_iter before the '
                                  'delta_pp / delta_pq tolerances were met.',
                                  RuntimeWarning)

            self._select_best_pass(results, verbose)

        else:
            # no surrogate: Laplace directly on the (true) density
            if step.x_0 is None:
                dim = self.density.input_size
                if dim is None:
                    raise RuntimeError('cannot choose a starting point: give '
                                       'OptimizeStep an x_0 or the density '
                                       'an input_size.')
                x_start = np.zeros(dim)
            else:
                x_start = self.density.from_original(step.x_0[0])
            traceable = self.density.device_logp(original_space=False,
                                                 use_surrogate=False)
            lap_res = step.laplace.run(
                logp=lambda x: _float64_call(traceable, x), x_0=x_start,
                traceable=traceable)
            x = self.density.to_original(lap_res.x_max)
            logp_trans = lap_res.f_max
            logp = self.density.to_original_density(density=logp_trans, x=x)
            results.append(OptimizeResult(
                x_max=PointDoublet(x, lap_res.x_max),
                f_max=DensityQuartet(float(logp), None, float(logp_trans),
                                     None),
                surrogate_list=(), var_dicts=None,
                laplace_samples=self.density.to_original(lap_res.samples),
                laplace_result=lap_res, samples=None, sample_trace=None))

        if step.has_surrogate and step.run_sampling:
            self._opt_sample()
        self._trace._i_optimize = 1
        if verbose:
            print('\n ***** OptimizeStep finished. ***** \n')

    def _opt_sample(self):
        """Sample the surrogate selected by the optimize phase (reference
        ``recipe.py:962-984``)."""
        step = self._trace._s_optimize
        results = self._trace._r_optimize
        trace = step.sample_trace

        if trace.x_0 is None:
            trace.x_0 = results[-1].laplace_samples
            trace._x_0_transformed = False
        if step.reuse_metric and isinstance(trace._metric, str):
            cov = results[-1].laplace_result.cov.copy()
            if trace._metric == 'diag':
                trace._metric = np.diag(cov)
            elif trace._metric == 'full':
                trace._metric = cov

        self._density.surrogate_list = list(results[-1].surrogate_list)
        self._density.use_surrogate = True
        tt = sample(self.density, sample_trace=trace)
        results[-1] = results[-1]._replace(samples=tt.get(flatten=True),
                                           sample_trace=tt)
        print('\n *** OptimizeStep: sampled the selected surrogate '
              'density. *** \n')

    # ------------------------- sample phase -------------------------------

    def _prev_context(self, k, this_step):
        """Locate the preceding step/result pair and extract warm-start
        samples and (if available) their surrogate logq values (reference
        ``recipe.py:1000-1026``)."""
        rt = self._trace
        have_prev = not (k == 0 and not rt._i_optimize)
        prev_step = prev_result = None
        if have_prev:
            if k == 0:
                prev_step, prev_result = rt._s_optimize, rt._r_optimize[-1]
            else:
                prev_step = rt._s_sample[k - 1]
                prev_result = rt._r_sample[k - 1]

        samples, transformed = None, False
        if have_prev or this_step.x_0 is not None:
            if this_step.x_0 is not None:
                samples = this_step.x_0
            elif prev_result.samples is not None:
                samples = prev_result.samples
            else:
                samples = Laplace.untemper_laplace_samples(
                    prev_result.laplace_result)
                transformed = True

        density = None
        if (have_prev and this_step.x_0 is None and
                prev_step.sample_trace is not None):
            density = prev_result.sample_trace.get(return_type='logp',
                                                   flatten=True)
        return prev_step, prev_result, samples, transformed, density

    @staticmethod
    def _warm_start(trace, this_step, prev_result, samples, transformed):
        """Carry x_0 / step size / metric over from the previous step
        (reference ``recipe.py:1027-1044``)."""
        if trace.x_0 is None and samples is not None:
            trace.x_0 = samples
            trace._x_0_transformed = transformed
        if prev_result is None or prev_result.sample_trace is None:
            return
        if trace._step_size is None and this_step.reuse_step_size:
            trace._step_size = _get_step_size(prev_result.sample_trace)
        if isinstance(trace._metric, str) and this_step.reuse_metric:
            trace._metric = _get_metric(prev_result.sample_trace,
                                        trace._metric)

    def _pick_fit_points(self, this_step, samples, density):
        """Choose refit points from the previous step's samples (reference
        ``recipe.py:1073-1082``)."""
        if density is not None:
            return this_step.resampler(density, this_step.n_eval)
        if this_step.n_eval > 0:
            return np.arange(this_step.n_eval)
        return np.arange(samples.shape[0])

    def _sam_step(self):
        rt = self._trace
        k = rt._i_sample
        this_step = rt._strategy.update(rt._r_sample)

        while this_step is not None:
            trace = this_step.sample_trace
            (prev_step, prev_result, prev_samples, prev_transformed,
             prev_density) = self._prev_context(k, this_step)

            if isinstance(trace, _HTrace):
                self._warm_start(trace, this_step, prev_result, prev_samples,
                                 prev_transformed)

            if this_step.has_surrogate:
                if not isinstance(self._density, Density):
                    raise RuntimeError('surrogate fitting needs a Density '
                                       '(a module pipeline).')
                self._density.surrogate_list = list(this_step.surrogate_list)

                var_dicts = None
                if not this_step.fitted:
                    if prev_samples is None:
                        raise RuntimeError('no points available to fit the '
                                           'surrogate: provide x_0 or run a '
                                           'previous step first.')
                    if (this_step.n_eval > 0 and
                            prev_samples.shape[0] < this_step.n_eval):
                        raise RuntimeError(
                            f'the surrogate fit wants n_eval = '
                            f'{this_step.n_eval} points but only '
                            f'{prev_samples.shape[0]} are available.')
                    if k > 0 and not prev_step.has_surrogate:
                        warnings.warn('fitting a surrogate from samples of '
                                      'the true density: the usual flow is '
                                      'the reverse; double-check the recipe '
                                      'ordering.', RuntimeWarning)

                    i_fit = self._pick_fit_points(this_step, prev_samples,
                                                  prev_density)
                    var_dicts = self._eval_true(prev_samples[i_fit])
                    var_dicts_fit = var_dicts.copy()

                    if this_step.reuse_samples:
                        for j in range(k):
                            if (j + this_step.reuse_samples >= k or
                                    this_step.reuse_samples < 0):
                                var_dicts_fit = np.concatenate(
                                    (var_dicts_fit,
                                     rt._r_sample[j].var_dicts))

                    if this_step.logp_cutoff and prev_density is not None:
                        var_dicts, var_dicts_fit = self._apply_logp_cutoff(
                            this_step, var_dicts, var_dicts_fit,
                            prev_samples, prev_density, i_fit)

                    self.density.fit(var_dicts_fit)

                self.density.use_surrogate = True
                tt = sample(self.density, sample_trace=trace)
                rt._r_sample.append(SampleResult(
                    samples=tt.get(flatten=True),
                    surrogate_list=deepcopy(list(
                        self._density._surrogate_list)),
                    var_dicts=var_dicts, sample_trace=tt))
            else:
                if isinstance(self._density, Density):
                    self.density.use_surrogate = False
                tt = sample(self.density, sample_trace=trace)
                rt._r_sample.append(SampleResult(
                    samples=tt.get(flatten=True), surrogate_list=(),
                    var_dicts=None, sample_trace=tt))

            rt._s_sample.append(this_step)
            print(f'\n *** SampleStep round #{k} done. *** \n')
            rt._i_sample += 1
            k = rt._i_sample
            this_step = rt._strategy.update(rt._r_sample)

        print('\n ***** SampleStep finished. ***** \n')

    def _apply_logp_cutoff(self, this_step, var_dicts, var_dicts_fit,
                           prev_samples, prev_density, i_fit):
        """Discard fit points whose true logp falls below the lowest
        surrogate logq among the selected points, then top back up to
        n_eval_min with fresh draws (reference ``recipe.py:1097-1155``)."""
        name = self.density.density_name
        logp_fit = _stack_logp(var_dicts_fit, name)
        logq_min = np.min(prev_density[i_fit])

        keep = logp_fit > logq_min
        frac = np.sum(keep) / logp_fit.size
        if frac < 0.5:
            warnings.warn('the logp cutoff rejected over half of the fit '
                          'points (true logp below the lowest selected '
                          'logq).', RuntimeWarning)
        if frac == 0.:
            raise RuntimeError(
                'every candidate fit point failed the logp cutoff — the '
                'surrogate and the true density disagree badly here. Check '
                'the recipe configuration, or disable logp_cutoff on this '
                'SampleStep.')

        var_dicts_fit = var_dicts_fit[keep]
        while len(var_dicts_fit) < this_step.n_eval_min:
            n_supp = max(int((this_step.n_eval_min - len(var_dicts_fit)) /
                             frac * this_step.alpha_supp), 4)
            if prev_samples.shape[0] < n_supp:
                raise RuntimeError('the previous step has too few samples '
                                   'to top up the fit set after the logp '
                                   'cutoff.')
            i_supp = this_step.resampler(prev_density, n_supp)
            vd_supp = self._eval_true(prev_samples[i_supp])
            keep = _stack_logp(vd_supp, name) > logq_min
            if np.sum(keep) < keep.size / 2:
                warnings.warn('the logp cutoff rejected over half of the '
                              'supplementary fit points.', RuntimeWarning)
            var_dicts = np.concatenate((var_dicts, vd_supp))
            var_dicts_fit = np.concatenate((var_dicts_fit, vd_supp[keep]))
        return var_dicts, var_dicts_fit

    # --------------------------- post phase -------------------------------

    def _last_samples(self):
        """Figure out what the last producing step left us: exact samples
        from the true density (p) or surrogate samples (q) (reference
        ``recipe.py:1220-1252``)."""
        rt = self._trace
        trace_p = trace_q = x_p = x_q = logp_p = logq_q = None

        if rt._i_sample:
            last_step = rt._s_sample[-1]
            last_result = rt._r_sample[-1]
            tt = last_result.sample_trace
            if last_step.has_surrogate:
                trace_q, x_q = tt, tt.get(return_type='samples',
                                          flatten=False)
                logq_q = tt.get(return_type='logp', flatten=False)
                self.density.surrogate_list = list(last_step.surrogate_list)
            else:
                trace_p, x_p = tt, tt.get(return_type='samples',
                                          flatten=False)
                logp_p = tt.get(return_type='logp', flatten=False)
        elif rt._i_optimize:
            last_step = rt._s_optimize
            last_result = rt._r_optimize[-1]
            if (last_step.has_surrogate and
                    last_result.sample_trace is not None):
                tt = last_result.sample_trace
                trace_q, x_q = tt, tt.get(return_type='samples',
                                          flatten=False)
                logq_q = tt.get(return_type='logp', flatten=False)
                self.density.surrogate_list = list(last_step.surrogate_list)
            else:
                warnings.warn('the PostStep found no MCMC samples to work '
                              'with.', RuntimeWarning)
        else:
            raise RuntimeError('the PostStep needs at least one completed '
                               'OptimizeStep or SampleStep.')
        return trace_p, trace_q, x_p, x_q, logp_p, logq_q

    def _pos_step(self):
        step = self._trace._s_post
        rt = self._trace

        trace_p, trace_q, x_p, x_q, logp_p, logq_q = self._last_samples()
        x_max = f_max = None
        if rt._i_optimize:
            opt = rt._r_optimize[-1]
            x_max, f_max = opt.x_max, opt.f_max

        samples = weights = weights_trunc = logp = logq = None
        logz = logz_err = None
        n_is_used = 0

        if x_p is not None:
            # exact samples: unit weights, optional evidence on p directly
            samples = x_p.reshape((-1, x_p.shape[-1]))
            weights = np.ones(samples.shape[0])
            weights_trunc = weights
            logp = logp_p.reshape(-1)
            if step.evidence_method is not None:
                logz, logz_err = step.evidence_method.run(
                    x_p=trace_p, logp=self._true_logp, logp_p=logp_p)
            if step.n_is > 0:
                warnings.warn('n_is is ignored: the last step already '
                              'sampled the true density.', RuntimeWarning)

        elif x_q is not None:
            samples = x_q.reshape((-1, x_q.shape[-1]))
            logq = logq_q.reshape(-1)

            if step.n_is != 0:
                n_is = step.n_is
                if n_is < 0 or n_is > samples.shape[0]:
                    if n_is > 0:
                        warnings.warn(
                            f'n_is = {n_is} exceeds the {samples.shape[0]} '
                            'available surrogate samples; reweighting all '
                            'of them instead.', RuntimeWarning)
                    n_is = samples.shape[0]
                else:
                    stride = int(samples.shape[0] / n_is)
                    samples = samples[::stride][:n_is]
                    logq = logq[::stride][:n_is]

                n_is_used = samples.shape[0]
                logp = np.asarray(self._true_logp(samples)).reshape(-1)
                # failed true-model evaluations (nan/inf logp — e.g. an
                # external likelihood returning nan rows, DES notebook
                # cell 12) get zero weight instead of poisoning the mean
                # that sets the truncation threshold
                bad = ~np.isfinite(logp) & ~np.isneginf(logp)
                if bad.any():
                    warnings.warn(
                        f'{int(bad.sum())}/{logp.size} importance-sampling '
                        'evaluations of the true density were non-finite; '
                        'they get zero weight.', RuntimeWarning)
                weights = np.where(bad, 0.0, np.exp(
                    np.where(bad, -np.inf, logp) - logq))
                if step.k_trunc < 0:
                    weights_trunc = weights.copy()
                else:
                    weights_trunc = np.clip(
                        weights, 0,
                        np.mean(weights) * n_is ** step.k_trunc)

                if step.evidence_method is not None:
                    logz, logz_err = self._evidence_with_is(
                        step, trace_q, logq_q, logp, logq)
            else:
                weights = np.ones(samples.shape[0])
                weights_trunc = weights
                if step.evidence_method is not None:
                    warnings.warn('with n_is = 0 the evidence below is that '
                                  'of the surrogate logq, not of the true '
                                  'logp.', RuntimeWarning)
                    logz, logz_err = step.evidence_method.run(
                        x_p=trace_q, logp=self._surro_logp, logp_p=logq_q)
        else:
            if step.n_is or step.evidence_method is not None:
                warnings.warn('importance sampling and evidence estimation '
                              'need MCMC samples; only Laplace samples are '
                              'available.', RuntimeWarning)

        try:
            n_call = rt.n_call + n_is_used
        except Exception:
            n_call = None
        rt._r_post = PostResult(
            samples, weights, weights_trunc, logp, logq, logz, logz_err,
            x_p, x_q, logp_p, logq_q, trace_p, trace_q, n_call, x_max, f_max)
        rt._i_post = 1
        print('\n ***** PostStep finished. ***** \n')

    def _evidence_with_is(self, step, trace_q, logq_q, logp, logq):
        """Evidence of q, importance-corrected to p: logz = logz_q +
        log E_q[p/q], with autocorrelation-aware errors combined in
        quadrature (reference ``recipe.py:1299-1308``)."""
        logz_q, logz_err_q = step.evidence_method.run(
            x_p=trace_q, logp=self._surro_logp, logp_p=logq_q)
        # failed true-model evaluations contribute zero density mass
        logp = np.where(~np.isfinite(logp) & ~np.isneginf(logp),
                        -np.inf, logp)
        logz_pq = logsumexp(logp - logq, b=1 / logp.size)
        ratio = np.exp(logp - logq - logz_pq)
        tau = float(integrated_time(ratio, quiet=True))
        err_pq = (np.var(ratio) / np.mean(ratio) ** 2 / logp.size * tau) ** 0.5
        return logz_q + logz_pq, float(np.hypot(logz_err_q, err_pq))

    # ------------------------------ API ------------------------------------

    def run(self):
        """Run every phase that has not finished yet (re-entrant; reference
        ``recipe.py:1345-1353``)."""
        done = self.recipe_trace.finished
        if not done.optimize:
            self._opt_step()
        if not done.sample:
            self._sam_step()
        if not done.post:
            self._pos_step()

    def get(self):
        """Return the PostResult of the Recipe."""
        if self._trace._r_post is None:
            raise RuntimeError('the PostStep has not run yet.')
        return self._trace._r_post

    def save(self, path):
        """Checkpoint the Recipe (all phase results and sampler carries)
        through ``utils/checkpoint.py``, every tensor lowered to the CPU.
        Requires the density's callables to be picklable (module-level
        functions, not lambdas). ``run()`` on the loaded Recipe resumes at
        the next unfinished phase."""
        from ..utils.checkpoint import save as _save
        _save(self, path)

    @staticmethod
    def load(path):
        """Load a Recipe saved with ``save``; a sample step that resumes
        moves its trace's carry to the configured device."""
        from ..utils.checkpoint import load as _load
        return _load(path)
