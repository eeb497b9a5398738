r"""First-class hyperparameters embedded in config dataclasses.

Rebuild of the reference's ``hyperparameter.py``
(``dair_pll/hyperparameter.py:36-309``): configs hold
``Float``/``Int``/``Categorical`` hyperparameter objects carrying both a
concrete value and a search distribution; :func:`traverse_config`
recursively discovers them, and suggestion/loading utilities let a study
layer optimize them. A copy of ``dair_pll_tpu/hyperparameter.py`` (it
imports no JAX). The reference delegates
distributions to optuna; here sampling is self-contained (optuna is not a
dependency).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np

# Default search ranges around a value (reference hyperparameter.py:90-185).
DEFAULT_LOG_RANGE = 100.0
DEFAULT_INT_RANGE = 4


class Hyperparameter:
    """A value plus a search distribution."""

    def __init__(self, value: Any) -> None:
        self._value = value

    @property
    def value(self) -> Any:
        """Concrete value used by the experiment."""
        return self._value

    @value.setter
    def value(self, new_value: Any) -> None:
        self._value = new_value

    def sample(self, rng: np.random.Generator) -> Any:
        """Draws one value from the search distribution."""
        raise NotImplementedError

    def from_unit(self, u: float) -> Any:
        """Maps ``u in [0, 1)`` through the distribution's inverse CDF
        (quasi-random sampling hook; role of optuna's QMCSampler in the
        reference's TPE/Hyperband stack, ``study.py:127-160``)."""
        raise NotImplementedError

    def to_unit(self, value: Any) -> float:
        """Inverse of :meth:`from_unit`: maps a concrete value to its
        CDF coordinate in ``[0, 1]`` (surrogate-model hook — adaptive
        samplers model observations in the unit hypercube)."""
        raise NotImplementedError

    def distribution(self) -> Dict[str, Any]:
        """JSON-serializable description of the distribution."""
        raise NotImplementedError


class Float(Hyperparameter):
    """Continuous hyperparameter, by default log-uniform around the value
    (reference ``hyperparameter.py:126-185``)."""

    def __init__(self, value: float, log: bool = True,
                 low: Optional[float] = None,
                 high: Optional[float] = None) -> None:
        super().__init__(float(value))
        self.log = log
        if low is None or high is None:
            if log:
                low = value / DEFAULT_LOG_RANGE
                high = value * DEFAULT_LOG_RANGE
            else:
                low = value / 2
                high = value * 2
        self.low = float(low)
        self.high = float(high)

    def sample(self, rng: np.random.Generator) -> float:
        return self.from_unit(float(rng.uniform()))

    def from_unit(self, u: float) -> float:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            return float(np.exp(lo + u * (hi - lo)))
        return float(self.low + u * (self.high - self.low))

    def to_unit(self, value: Any) -> float:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            u = (math.log(value) - lo) / max(hi - lo, 1e-300)
        else:
            u = (value - self.low) / max(self.high - self.low, 1e-300)
        return float(min(max(u, 0.0), 1.0))

    def distribution(self) -> Dict[str, Any]:
        return {"type": "float", "low": self.low, "high": self.high,
                "log": self.log}


class Int(Hyperparameter):
    """Integer hyperparameter, by default log-uniform around the value."""

    def __init__(self, value: int, log: bool = True,
                 low: Optional[int] = None,
                 high: Optional[int] = None) -> None:
        super().__init__(int(value))
        self.log = log
        if low is None or high is None:
            if log:
                low = max(1, value // DEFAULT_INT_RANGE)
                high = value * DEFAULT_INT_RANGE
            else:
                low = max(1, value - DEFAULT_INT_RANGE)
                high = value + DEFAULT_INT_RANGE
        self.low = int(low)
        self.high = int(high)

    def sample(self, rng: np.random.Generator) -> int:
        return self.from_unit(float(rng.uniform()))

    def from_unit(self, u: float) -> int:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            return int(round(np.exp(lo + u * (hi - lo))))
        span = self.high - self.low + 1
        return int(min(self.high, self.low + int(u * span)))

    def to_unit(self, value: Any) -> float:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            u = (math.log(max(int(value), 1)) - lo) / max(hi - lo, 1e-300)
        else:
            span = self.high - self.low + 1
            u = (int(value) - self.low + 0.5) / span
        return float(min(max(u, 0.0), 1.0))

    def distribution(self) -> Dict[str, Any]:
        return {"type": "int", "low": self.low, "high": self.high,
                "log": self.log}


class Categorical(Hyperparameter):
    """Categorical hyperparameter over explicit choices (reference
    ``hyperparameter.py:189-204``)."""

    def __init__(self, value: Any, choices: Sequence[Any]) -> None:
        super().__init__(value)
        assert value in choices
        self.choices = list(choices)

    def sample(self, rng: np.random.Generator) -> Any:
        return self.choices[int(rng.integers(len(self.choices)))]

    def from_unit(self, u: float) -> Any:
        return self.choices[min(len(self.choices) - 1,
                                int(u * len(self.choices)))]

    def to_unit(self, value: Any) -> float:
        index = self.choices.index(value)
        return (index + 0.5) / len(self.choices)

    def distribution(self) -> Dict[str, Any]:
        return {"type": "categorical", "choices": self.choices}


def traverse_config(config: Any, prefix: str = "") -> Dict[
        str, Hyperparameter]:
    """Recursively finds all hyperparameters in a (nested dataclass) config.

    Mirrors reference ``hyperparameter.py:207-236``; keys are dotted
    attribute paths.
    """
    found: Dict[str, Hyperparameter] = {}
    if isinstance(config, Hyperparameter):
        found[prefix.rstrip(".")] = config
        return found
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        for field in dataclasses.fields(config):
            value = getattr(config, field.name)
            found.update(traverse_config(value, f"{prefix}{field.name}."))
    elif isinstance(config, dict):
        for key, value in config.items():
            found.update(traverse_config(value, f"{prefix}{key}."))
    elif isinstance(config, (list, tuple)):
        for index, value in enumerate(config):
            found.update(traverse_config(value, f"{prefix}{index}."))
    return found


def generate_suggestion(config: Any,
                        rng: np.random.Generator) -> Dict[str, Any]:
    """Samples a value for every hyperparameter in the config and applies
    it in place (reference ``hyperparameter.py:238-265``).

    Returns:
        Dotted-path to sampled value mapping.
    """
    suggestion = {}
    for name, hyperparameter in traverse_config(config).items():
        value = hyperparameter.sample(rng)
        hyperparameter.value = value
        suggestion[name] = value
    return suggestion


def generate_quasirandom_suggestions(config: Any, n: int,
                                     seed: int = 0) -> list:
    """Samples ``n`` suggestions from a scrambled Sobol sequence over the
    config's hyperparameter space (deterministic in ``seed``).

    Low-discrepancy sampling covers the search space measurably better
    than i.i.d. random draws at equal trial budgets — the self-contained
    stand-in for the reference's optuna TPE sampler
    (``dair_pll/study.py:127-160``; optuna is not
    installable here). Falls back to stratified jittered sampling if
    scipy's QMC module is unavailable.

    Returns:
        List of ``n`` dotted-path -> value dicts (does NOT modify the
        config; apply one with :func:`load_suggestion`).
    """
    hyperparameters = traverse_config(config)
    names = list(hyperparameters)
    dim = len(names)
    if dim == 0:
        return [{} for _ in range(n)]
    try:
        from scipy.stats import qmc
        sampler = qmc.Sobol(d=dim, scramble=True, seed=seed)
        unit = sampler.random(n)
    except ImportError:  # pragma: no cover - scipy is in the image
        rng = np.random.default_rng(seed)
        # Stratified jitter: each dimension's n strata in random order.
        unit = np.empty((n, dim))
        for j in range(dim):
            strata = (rng.permutation(n) + rng.uniform(size=n)) / n
            unit[:, j] = strata
    return [{name: hyperparameters[name].from_unit(float(unit[i, j]))
             for j, name in enumerate(names)} for i in range(n)]


def _parzen_log_density(points: np.ndarray, queries: np.ndarray) -> \
        np.ndarray:
    """Log density of a truncated-Gaussian Parzen estimator on the unit
    hypercube: one isotropic component per observed point, Scott-rule
    bandwidth per dimension, uniform floor for numerical safety."""
    n, dim = points.shape
    sigma = np.clip(n ** (-1.0 / (dim + 4)) *
                    np.maximum(points.std(axis=0), 1e-3), 1e-3, 1.0)
    # (n_queries, n_points, dim) squared z-scores.
    z2 = ((queries[:, None, :] - points[None, :, :]) / sigma) ** 2
    comp = -0.5 * z2.sum(axis=-1) - np.log(sigma).sum()
    m = comp.max(axis=1, keepdims=True)
    density = np.exp(m).squeeze(1) * np.exp(comp - m).mean(axis=1)
    return np.log(density + 1e-300)


def generate_tpe_suggestions(config: Any,
                             observations: Sequence[Dict[str, Any]],
                             losses: Sequence[float], n: int,
                             seed: int = 0, gamma: float = 0.25,
                             n_candidates: int = 64) -> list:
    """Tree-structured-Parzen-Estimator suggestions conditioned on
    completed trials: the self-contained analogue of the reference's
    optuna TPE sampler (``dair_pll/study.py:127-160``).

    Observed suggestions map to the unit hypercube (``to_unit``), split
    at the ``gamma`` quantile of loss into good/bad sets, each modeled by
    a Parzen (truncated-Gaussian kernel) density; candidates drawn around
    good points are ranked by ``log l_good(x) - log l_bad(x)`` and the
    top ``n`` returned. Deterministic in ``(seed, observations)`` — the
    cross-process study coordinator relies on every process deriving
    identical suggestions from gathered rung results.

    Falls back to Sobol when fewer than 4 finite-loss observations exist.
    """
    hyperparameters = traverse_config(config)
    names = list(hyperparameters)
    dim = len(names)
    finite = [(obs, loss) for obs, loss in zip(observations, losses)
              if math.isfinite(loss) and all(k in obs for k in names)]
    if dim == 0:
        return [{} for _ in range(n)]
    if len(finite) < 4:
        return generate_quasirandom_suggestions(config, n, seed)

    unit = np.array([[hyperparameters[k].to_unit(obs[k]) for k in names]
                     for obs, _ in finite])
    order = np.argsort([loss for _, loss in finite], kind="stable")
    n_good = max(2, int(math.ceil(gamma * len(finite))))
    good, bad = unit[order[:n_good]], unit[order[n_good:]]
    if len(bad) < 2:
        bad = unit  # degenerate split: rank against the full density

    rng = np.random.default_rng(seed)
    suggestions = []
    for _ in range(n):
        centers = good[rng.integers(len(good), size=n_candidates)]
        sigma = np.clip(
            len(good) ** (-1.0 / (dim + 4)) *
            np.maximum(good.std(axis=0), 1e-3), 1e-3, 1.0)
        cand = np.clip(
            centers + rng.standard_normal((n_candidates, dim)) * sigma,
            0.0, 1.0 - 1e-9)
        score = (_parzen_log_density(good, cand) -
                 _parzen_log_density(bad, cand))
        best = cand[int(np.argmax(score))]
        suggestions.append({k: hyperparameters[k].from_unit(float(best[j]))
                            for j, k in enumerate(names)})
    return suggestions


def load_suggestion(config: Any, suggestion: Dict[str, Any]) -> None:
    """Applies a saved suggestion to the config's hyperparameters
    (reference ``hyperparameter.py:267-288``)."""
    hyperparameters = traverse_config(config)
    for name, value in suggestion.items():
        if name in hyperparameters:
            hyperparameters[name].value = value


def hyperparameter_values(config: Any) -> Dict[str, Any]:
    """Current values of all hyperparameters in the config (reference
    ``hyperparameter.py:290-309``)."""
    return {name: h.value
            for name, h in traverse_config(config).items()}
