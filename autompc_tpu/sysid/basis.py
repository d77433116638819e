"""Basis-function library for SINDy/Koopman feature maps.

Re-creates the reference basis library (reference:
autompc/sysid/basis_funcs.py:8-126) as *vectorized jax feature maps*: a
``FeatureLibrary`` is built once from static config and evaluates
``Theta(z) -> (n_features,)`` for a combined input vector ``z = [x, u]``
as one traced expression. Gradients come from jax autodiff instead of the
reference's hand-written ``grad_func`` lambdas.

Feature enumeration order matches pysindy's CustomLibrary semantics used
by the reference (sindy.py:146-151): each basis function is applied to
every size-``n_args`` combination of input dimensions, in combination
order, functions in library order.
"""

from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# A term is (name, fn) or (name, fn, grads) where fn maps the full
# input vector z -> scalar and grads is a tuple of (comp_idx, grad_fn)
# pairs — the term's nonzero partial derivatives, each grad_fn mapping
# z -> d(term)/d(z_comp). The sparse form mirrors the reference's
# hand-written per-basis grad_func lambdas (basis_funcs.py:22-126) and
# feeds the fused line-search kernel's Jacobians
# (ops/pallas_linesearch.py), where evaluating only the genuinely
# nonzero partials — built from sin/cos subexpressions the compiler
# CSEs across terms — avoids d redundant primal re-evaluations.
Term = Tuple[str, Callable]


def identity_terms(n_inputs: int) -> List[Term]:
    """x_i (basis_funcs.py:16-20)."""
    return [
        (f"z{i}", lambda z, i=i: z[i], ((i, lambda z: 1.0),))
        for i in range(n_inputs)
    ]


def poly_terms(n_inputs: int, degree: int) -> List[Term]:
    """x_i^degree (basis_funcs.py:22-26)."""
    return [
        (
            f"z{i}^{degree}",
            lambda z, i=i, d=degree: z[i] ** d,
            ((i, lambda z, i=i, d=degree: d * z[i] ** (d - 1)),),
        )
        for i in range(n_inputs)
    ]


def cross_terms(n_inputs: int, degree: int) -> List[Term]:
    """Products of powers over distinct variables with total degree
    ``degree`` (basis_funcs.py:28-95): for each multiset of positive
    exponents summing to ``degree`` (with >= 2 variables up to
    ``degree`` variables), applied to each combination of distinct
    input dimensions."""
    # Enumerate exponent tuples like the reference: compositions of
    # `degree` into k >= 1 positive parts, deduplicated as tuples.
    exps: List[Tuple[int, ...]] = []
    seen = set()

    def compositions(total, parts):
        if parts == 1:
            yield (total,)
            return
        for first in range(1, total - parts + 2):
            for rest in compositions(total - first, parts - 1):
                yield (first,) + rest

    for k in range(1, degree + 1):
        for exp in compositions(degree, k):
            if exp not in seen:
                seen.add(exp)
                exps.append(exp)

    terms: List[Term] = []
    for exp in exps:
        k = len(exp)
        if k == 1:
            # plain power handled by poly_terms; the reference's
            # cross-term generator also emits it — keep parity by
            # skipping only if exponent == degree handled there.
            continue
        for combo in itertools.combinations(range(n_inputs), k):
            name = " ".join(f"z{i}^{e}" for i, e in zip(combo, exp))

            def fn(z, combo=combo, exp=exp):
                val = 1.0
                for i, e in zip(combo, exp):
                    val = val * z[i] ** e
                return val

            def grad_wrt(i0, e0, combo=combo, exp=exp):
                def g(z, i0=i0, e0=e0):
                    val = e0 * z[i0] ** (e0 - 1) if e0 > 1 else float(e0)
                    for i, e in zip(combo, exp):
                        if i != i0:
                            val = val * z[i] ** e
                    return val

                return g

            grads = tuple(
                (i, grad_wrt(i, e)) for i, e in zip(combo, exp)
            )
            terms.append((name, fn, grads))
    return terms


def trig_terms(n_inputs: int, freq: int) -> List[Term]:
    """sin(freq x_i), cos(freq x_i) (basis_funcs.py:97-106)."""
    out: List[Term] = []
    for i in range(n_inputs):
        out.append((
            f"sin({freq} z{i})",
            lambda z, i=i, f=freq: jnp.sin(f * z[i]),
            ((i, lambda z, i=i, f=freq: f * jnp.cos(f * z[i])),),
        ))
        out.append((
            f"cos({freq} z{i})",
            lambda z, i=i, f=freq: jnp.cos(f * z[i]),
            ((i, lambda z, i=i, f=freq: -f * jnp.sin(f * z[i])),),
        ))
    return out


def trig_interaction_terms(n_inputs: int, freq: int) -> List[Term]:
    """x_i sin(freq x_j) and x_i cos(freq x_j) for i != j
    (basis_funcs.py:108-126: both argument orders of each pair)."""
    out: List[Term] = []
    for i, j in itertools.combinations(range(n_inputs), 2):
        out.append((
            f"z{i} sin({freq} z{j})",
            lambda z, i=i, j=j, f=freq: z[i] * jnp.sin(f * z[j]),
            (
                (i, lambda z, j=j, f=freq: jnp.sin(f * z[j])),
                (j, lambda z, i=i, j=j, f=freq: f * z[i] * jnp.cos(f * z[j])),
            ),
        ))
        out.append((
            f"z{j} sin({freq} z{i})",
            lambda z, i=i, j=j, f=freq: z[j] * jnp.sin(f * z[i]),
            (
                (j, lambda z, i=i, f=freq: jnp.sin(f * z[i])),
                (i, lambda z, i=i, j=j, f=freq: f * z[j] * jnp.cos(f * z[i])),
            ),
        ))
        out.append((
            f"z{i} cos({freq} z{j})",
            lambda z, i=i, j=j, f=freq: z[i] * jnp.cos(f * z[j]),
            (
                (i, lambda z, j=j, f=freq: jnp.cos(f * z[j])),
                (j, lambda z, i=i, j=j, f=freq: -f * z[i] * jnp.sin(f * z[j])),
            ),
        ))
        out.append((
            f"z{j} cos({freq} z{i})",
            lambda z, i=i, j=j, f=freq: z[j] * jnp.cos(f * z[i]),
            (
                (j, lambda z, i=i, f=freq: jnp.cos(f * z[i])),
                (i, lambda z, i=i, j=j, f=freq: -f * z[j] * jnp.sin(f * z[i])),
            ),
        ))
    return out


class FeatureLibrary:
    """A static list of feature terms over a combined input vector.

    Evaluation is organized in vectorized *blocks* (identity, per-freq
    trig, per-freq trig interactions, per-degree powers, cross terms):
    each block is a handful of whole-array ops along the last axis
    instead of one traced op per scalar term. Inside an MPC rollout scan
    this is the difference between ~40 tiny ops per step and ~8 fused
    array ops followed by one feature-matrix matmul —
    the feature evaluation sits on the hot path of every SINDy-backed
    solver (iLQR line search, MPPI rollouts, DT defects).

    Block functions operate on the last axis, so the same code path
    serves single vectors (d,), batches (N, d), and arbitrary vmapped
    shapes. Term order matches the scalar enumeration (`self.names`), so
    coefficient layouts are interchangeable.
    """

    def __init__(self, terms: Sequence[Term], blocks=None, jac_blocks=None):
        self.names = [t[0] for t in terms]
        self._fns = [t[1] for t in terms]
        self._blocks = blocks  # list of callables Z -> (..., k)
        self._jac_blocks = jac_blocks  # list of callables Z -> (..., k, d)
        self._term_grads = [
            tuple(t[2]) if len(t) > 2 else None for t in terms
        ]

    @property
    def n_features(self) -> int:
        return len(self._fns)

    @property
    def grad_terms(self):
        """Sparse per-term analytic gradients as a static (hashable)
        tuple — ``grad_terms[k]`` is a tuple of ``(comp_idx, grad_fn)``
        pairs for term k — or ``None`` if any term lacks them (custom
        term lists). Consumed by the fused line-search kernel
        (ops/pallas_linesearch.py)."""
        if any(g is None for g in self._term_grads):
            return None
        return tuple(self._term_grads)

    def __call__(self, z):
        """z: (..., n_inputs) -> (..., n_features). Traceable."""
        if self._blocks is not None:
            return jnp.concatenate([blk(z) for blk in self._blocks], axis=-1)
        return jnp.stack([fn(z) for fn in self._fns], axis=-1)

    def jacobian(self, z):
        """Analytic feature Jacobian: z (..., d) -> (..., F, d).

        One feature-evaluation's worth of work instead of jacfwd's d
        pushforwards — this sits on the relinearization hot path of
        every Gauss-Newton style solver over linear-in-features models.
        Falls back to jacfwd when no analytic blocks are available.
        """
        if self._jac_blocks is None:
            return jax.jacfwd(self.__call__)(z)
        return jnp.concatenate([blk(z) for blk in self._jac_blocks], axis=-2)

    @staticmethod
    def from_config(
        n_inputs: int,
        poly_basis: bool = False,
        poly_degree: int = 3,
        poly_cross_terms: bool = False,
        trig_basis: bool = False,
        trig_freq: int = 1,
        trig_interaction: bool = False,
    ) -> "FeatureLibrary":
        """Build the library the reference SINDy assembles from its
        hyperparameters (sindy.py:136-150): identity always; trig (+
        interactions) per frequency 1..trig_freq; polynomial powers
        2..poly_degree (+ cross terms)."""
        d = n_inputs
        eye = jnp.eye(d)
        terms: List[Term] = list(identity_terms(n_inputs))
        blocks = [lambda z: z]
        jac_blocks = [
            lambda z: jnp.broadcast_to(eye, z.shape[:-1] + (d, d))
        ]
        if trig_basis:
            for freq in range(1, trig_freq + 1):
                terms += trig_terms(n_inputs, freq)

                def trig_blk(z, f=freq):
                    # interleave [sin(f z0), cos(f z0), sin(f z1), ...]
                    s = jnp.sin(f * z)
                    c = jnp.cos(f * z)
                    return jnp.stack([s, c], axis=-1).reshape(
                        z.shape[:-1] + (2 * z.shape[-1],)
                    )

                blocks.append(trig_blk)

                def trig_jac(z, f=freq):
                    c = f * jnp.cos(f * z)          # d sin
                    s = -f * jnp.sin(f * z)         # d cos
                    sin_rows = c[..., :, None] * eye
                    cos_rows = s[..., :, None] * eye
                    J = jnp.stack([sin_rows, cos_rows], axis=-2)
                    return J.reshape(z.shape[:-1] + (2 * d, d))

                jac_blocks.append(trig_jac)
                if trig_interaction:
                    terms += trig_interaction_terms(n_inputs, freq)
                    pairs = list(itertools.combinations(range(n_inputs), 2))
                    ii = np.array([p[0] for p in pairs])
                    jj = np.array([p[1] for p in pairs])
                    Ei = jnp.asarray(np.eye(d)[ii])  # (P, d)
                    Ej = jnp.asarray(np.eye(d)[jj])

                    def inter_blk(z, f=freq, ii=ii, jj=jj):
                        # per pair: [zi sin(f zj), zj sin(f zi),
                        #            zi cos(f zj), zj cos(f zi)]
                        zi = z[..., ii]
                        zj = z[..., jj]
                        out = jnp.stack(
                            [
                                zi * jnp.sin(f * zj),
                                zj * jnp.sin(f * zi),
                                zi * jnp.cos(f * zj),
                                zj * jnp.cos(f * zi),
                            ],
                            axis=-1,
                        )
                        return out.reshape(z.shape[:-1] + (4 * len(ii),))

                    blocks.append(inter_blk)

                    def inter_jac(z, f=freq, ii=ii, jj=jj, Ei=Ei, Ej=Ej):
                        zi = z[..., ii]
                        zj = z[..., jj]
                        sfj, cfj = jnp.sin(f * zj), jnp.cos(f * zj)
                        sfi, cfi = jnp.sin(f * zi), jnp.cos(f * zi)
                        ex = lambda a: a[..., :, None]  # (..., P, 1)
                        J = jnp.stack(
                            [
                                ex(sfj) * Ei + ex(f * zi * cfj) * Ej,
                                ex(sfi) * Ej + ex(f * zj * cfi) * Ei,
                                ex(cfj) * Ei + ex(-f * zi * sfj) * Ej,
                                ex(cfi) * Ej + ex(-f * zj * sfi) * Ei,
                            ],
                            axis=-2,
                        )  # (..., P, 4, d)
                        return J.reshape(z.shape[:-1] + (4 * len(ii), d))

                    jac_blocks.append(inter_jac)
        if poly_basis:
            for deg in range(2, poly_degree + 1):
                terms += poly_terms(n_inputs, deg)
                blocks.append(lambda z, k=deg: z**k)
                jac_blocks.append(
                    lambda z, k=deg: (k * z ** (k - 1))[..., :, None] * eye
                )
            if poly_cross_terms:
                cross = []
                for deg in range(2, poly_degree + 1):
                    cross += cross_terms(n_inputs, deg)
                terms += cross
                # Exponent matrix reconstruction from term names would be
                # brittle; rebuild it alongside the enumeration.
                E = _cross_exponent_matrix(n_inputs, poly_degree)

                def cross_blk(z, E=jnp.asarray(E, dtype=float)):
                    # prod_d z_d^{E[t,d]} for each cross term t.
                    zb = z[..., None, :]  # (..., 1, d)
                    return jnp.prod(zb ** E, axis=-1)

                if len(cross) != E.shape[0]:
                    raise AssertionError("cross-term enumeration mismatch")
                blocks.append(cross_blk)

                En = np.asarray(E)

                def cross_jac(z, En=En):
                    cols = []
                    zb = z[..., None, :]  # (..., 1, d)
                    for j in range(d):
                        E_mod = En.copy()
                        E_mod[:, j] = 0.0
                        prod_wo_j = jnp.prod(
                            zb ** jnp.asarray(E_mod), axis=-1
                        )  # (..., T)
                        e_j = En[:, j]
                        dz_j = jnp.where(
                            jnp.asarray(e_j) > 0,
                            jnp.asarray(e_j)
                            * z[..., j, None] ** jnp.asarray(np.maximum(e_j - 1, 0)),
                            0.0,
                        )
                        cols.append(prod_wo_j * dz_j)
                    return jnp.stack(cols, axis=-1)  # (..., T, d)

                jac_blocks.append(cross_jac)
        return FeatureLibrary(terms, blocks=blocks, jac_blocks=jac_blocks)


def _cross_exponent_matrix(n_inputs: int, poly_degree: int) -> np.ndarray:
    """Exponent rows matching cross_terms enumeration for degrees
    2..poly_degree."""
    rows = []
    for degree in range(2, poly_degree + 1):
        exps = []
        seen = set()

        def compositions(total, parts):
            if parts == 1:
                yield (total,)
                return
            for first in range(1, total - parts + 2):
                for rest in compositions(total - first, parts - 1):
                    yield (first,) + rest

        for k in range(1, degree + 1):
            for exp in compositions(degree, k):
                if exp not in seen:
                    seen.add(exp)
                    exps.append(exp)
        for exp in exps:
            k = len(exp)
            if k == 1:
                continue
            for combo in itertools.combinations(range(n_inputs), k):
                row = np.zeros(n_inputs)
                for i, e in zip(combo, exp):
                    row[i] = e
                rows.append(row)
    return np.array(rows) if rows else np.zeros((0, n_inputs))


def finite_difference(x: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Second-order finite-difference time derivative along axis 0:
    centered in the interior, one-sided at the boundaries (the
    differentiation scheme the reference's continuous-time SINDy relies
    on via pysindy's FiniteDifference)."""
    interior = (x[2:] - x[:-2]) / (2 * dt)
    first = (-3 * x[0] + 4 * x[1] - x[2])[None] / (2 * dt)
    last = (3 * x[-1] - 4 * x[-2] + x[-3])[None] / (2 * dt)
    return jnp.concatenate([first, interior, last], axis=0)
