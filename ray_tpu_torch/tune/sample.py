"""Search-space primitives.

Mirrors the reference's ray.tune.sample (python/ray/tune/sample.py):
Domain objects (uniform/loguniform/randint/choice/...) plus the
``grid_search`` marker dict consumed by the variant generator.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: Optional[random.Random] = None) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform needs lower > 0")
        self.lower, self.upper, self.log = lower, upper, log
        self._quantum: Optional[float] = None

    def quantized(self, q: float) -> "Float":
        self._quantum = q
        return self

    def sample(self, rng=None):
        rng = rng or random
        if self.log:
            import math

            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self._quantum:
            v = round(v / self._quantum) * self._quantum
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper
        # grid step (qrandint); visible to model-based searchers so their
        # suggestions can snap back onto the grid, like Float._quantum
        self._quantum: Optional[int] = None

    def sample(self, rng=None):
        rng = rng or random
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng=None):
        rng = rng or random
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, func):
        self.func = func

    def sample(self, rng=None):
        try:
            return self.func(None)
        except TypeError:
            return self.func()


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper).quantized(q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    class _Q(Integer):
        def sample(self, rng=None):
            v = super().sample(rng)
            return int(round(v / q) * q)
    dom = _Q(lower, upper)
    dom._quantum = q
    return dom


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(func) -> Function:
    return Function(func)


def randn(mean: float = 0.0, sd: float = 1.0) -> Function:
    return Function(lambda _=None: random.gauss(mean, sd))


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Marker consumed by the variant generator."""
    return {"grid_search": list(values)}
