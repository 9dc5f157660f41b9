"""Symmetric 3x3 eigen-decomposition and the Umeyama rotation in tensor
ops that read nothing back to the host, so that ICP's iteration and the
normal estimate can be captured into a CUDA graph.

`torch.linalg.svd` and `torch.linalg.eigh` cannot be captured on the card
(PyTorch 2.11, CUDA 12.8): the SVD of a small matrix copies through host
memory ("Cannot copy between CPU and CUDA tensors during CUDA graph
capture"), and the eigen solver's cuSOLVER call fails under capture
("CUSOLVER_STATUS_INTERNAL_ERROR ... cusolverDnXsyevd" for one matrix,
"operation not permitted when stream is capturing" for a batch). On a
CUDA device the reference's `jnp.linalg.svd` / `eigh`
(visma_tpu/align/umeyama.py, visma_tpu/align/icp.py:32-57) become:

  sym3_eigh         cyclic Jacobi over a batch of symmetric 3x3 matrices,
                    a fixed number of sweeps, in float64;
  kabsch_rotation   U diag(1, 1, d) V^T of a 3x3 matrix's SVD (d the sign
                    of det(U V^T)) from the eigenvectors of M^T M: the
                    two leading right singular vectors, their images under
                    M, and the cross products that complete both bases as
                    rotations. No SVD sign choice reaches the result.

On the CPU, where nothing is captured, `umeyama_rotation` and
`sym3_eigvecs` call LAPACK (`torch.linalg.svd` / `eigh` in float32), as
the reference does on its CPU. Its float32 SVD's factors are orthogonal
only to float32 rounding, and 30 ICP steps of them drift a pose's
singular values by about 5e-6; the Jacobi's rotation is orthogonal to
float64 rounding. Which form runs is `capturable(tensor)`.
"""
from __future__ import annotations

import torch

# Jacobi sweeps: a sweep rotates each of the three pairs once and the off-
# diagonal part falls quadratically. Four sweeps leave V diag(w) V^T - A at
# float64 rounding (3e-15 relative) on random, near-identity, clustered and
# 1e18-conditioned matrices, where three leave 6e-7; the Umeyama rotation,
# returned in float32, takes three (6e-8 from the float64 SVD's)
SWEEPS = 4
KABSCH_SWEEPS = 3
_PAIRS = ((0, 1), (0, 2), (1, 2))


def capturable(t: torch.Tensor) -> bool:
    """Whether the linear algebra of `t` takes the forms a CUDA graph can
    capture (`kabsch_rotation`, `sym3_eigh`): on a CUDA device."""
    return t.device.type == "cuda"


def _givens(p: int, q: int, c, s, zero, one) -> torch.Tensor:
    """(..., 3, 3): the identity with [p,p] = [q,q] = c, [p,q] = s,
    [q,p] = -s."""
    r = 3 - p - q
    e = [[None] * 3 for _ in range(3)]
    e[p][p], e[q][q], e[r][r] = c, c, one
    e[p][q], e[q][p] = s, -s
    e[p][r] = e[r][p] = e[q][r] = e[r][q] = zero
    return torch.stack([x for row in e for x in row],
                       dim=-1).unflatten(-1, (3, 3))


def sym3_eigh(A: torch.Tensor, sweeps: int = SWEEPS):
    """Eigenvalues ascending (..., 3) and eigenvectors as columns
    (..., 3, 3) of symmetric (..., 3, 3) `A`, in float64: `sweeps` cyclic
    Jacobi sweeps (Golub & Van Loan, Algorithm 8.5.2), each rotation the
    smaller of the two that zero its pair."""
    A = A.to(torch.float64)
    A = 0.5 * (A + A.mT)
    zero = torch.zeros_like(A[..., 0, 0])
    one = torch.ones_like(zero)
    V = None
    for _ in range(sweeps):
        for p, q in _PAIRS:
            d = A[..., q, q] - A[..., p, p]
            apq2 = 2.0 * A[..., p, q]
            # t = tan(theta) = 2 a_pq / (d + sign(d) hypot(d, 2 a_pq)):
            # 0 where the pair is already zero
            h = torch.clamp(torch.hypot(d, apq2), min=1e-300)
            t = apq2 / (d + torch.copysign(h, d))
            c = torch.rsqrt(torch.addcmul(one, t, t))
            J = _givens(p, q, c, t * c, zero, one)
            A = J.mT @ A @ J
            V = J if V is None else V @ J
    w, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1,
                          stable=True)
    return w, torch.take_along_dim(V, order[..., None, :], dim=-1)


def sym3_eigvecs(A: torch.Tensor) -> torch.Tensor:
    """Eigenvectors as columns, ascending, of symmetric (..., 3, 3) `A`
    in A's dtype: `sym3_eigh`'s where `capturable(A)`, else LAPACK's."""
    if capturable(A):
        return sym3_eigh(A)[1].to(A.dtype)
    return torch.linalg.eigh(A)[1]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-300)


def kabsch_rotation(M: torch.Tensor) -> torch.Tensor:
    """The rotation R maximising trace(R^T M) for (..., 3, 3) `M`:
    U diag(1, 1, d) V^T of M = U S V^T with d = sign(det(U) det(V)),
    in float64. The identity for M = 0; where M has rank 1 the second
    axis is completed from the coordinate axis least aligned with the
    first (any completion maximises the trace)."""
    M = M.to(torch.float64)
    V = sym3_eigh(M.mT @ M, KABSCH_SWEEPS)[1]
    v1, v2 = V[..., :, 2], V[..., :, 1]            # leading two
    m1 = (M @ v1[..., None])[..., 0]
    m2 = (M @ v2[..., None])[..., 0]
    u1 = _unit(m1)
    m2 = m2 - torch.sum(u1 * m2, -1, keepdim=True) * u1
    # the coordinate axis least aligned with u1, made orthogonal to it (a
    # comparison, not an index: a 0-d index tensor is read back)
    least = torch.argmin(u1.abs(), dim=-1, keepdim=True)
    axis = (torch.arange(3, device=M.device) == least).to(M.dtype)
    axis = axis - torch.sum(u1 * axis, -1, keepdim=True) * u1
    n1 = torch.linalg.vector_norm(m1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(m2, dim=-1, keepdim=True)
    u2 = _unit(torch.where(n2 > 1e-12 * n1, m2, axis))
    U = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)
    Vp = torch.stack([v1, v2, torch.linalg.cross(v1, v2)], dim=-1)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    return torch.where(n1[..., None] > 0, U @ Vp.mT, eye)


def umeyama_rotation(M: torch.Tensor):
    """(R, trace(R^T M)) of a 3x3 `M`, R = U diag(1, 1, d) V^T in M's
    dtype: `kabsch_rotation` where `capturable(M)`, else LAPACK's SVD (the
    trace then sum(S diag(1, 1, d)), as the reference computes it)."""
    if capturable(M):
        R64 = kabsch_rotation(M)
        return R64.to(M.dtype), torch.sum(R64 * M.to(R64.dtype)).to(M.dtype)
    U, S, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    one = torch.ones((), dtype=M.dtype, device=M.device)
    Dg = torch.stack([one, one, d])
    return (U * Dg) @ Vt, torch.sum(S * Dg)
