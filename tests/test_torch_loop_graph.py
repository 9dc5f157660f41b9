"""The last jitted loops of the reference in their compiled form on the
CPU: `icp` (one iteration replayed, the reference's jit + `lax.scan`), the
PCA normals and the surface distance (one query chunk replayed, the
reference's jitted `lax.map`) and the renderers' `render_depth` (one call
replayed) through `utils.graphs`' buffers (`graph=True`: on the CPU the
graph's static buffers without capture) against their eager loops
(`graph=False`) bit for bit, and against the JAX package with the
tolerances of the tests that hold the eager port to it; the symmetric 3x3
Jacobi and the Umeyama rotation that replace `eigh` / `svd` (which cannot
be captured on the card) against float64 NumPy, and through ICP and the
normals in place of LAPACK's (the card's forms); the ICP graphs' LRU; one
capture per shape on stand-in streams and graphs; a graphed render inside
a running capture raising; `set_mesh` / `set_stack` after a graphed render
rendering the new meshes."""
import sys
from collections import OrderedDict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch.utils._python_dispatch import TorchDispatchMode

import visma_tpu.align as JA
from visma_tpu.align.icp import _estimate_normals as j_normals

import visma_tpu_torch.align as TA
from visma_tpu_torch.align.eig3 import kabsch_rotation, sym3_eigh
from visma_tpu_torch.align.icp import _estimate_normals
from visma_tpu_torch.eval import metrics as TM
from visma_tpu_torch.render import raster as TR
from visma_tpu_torch.utils import graphs
from visma_tpu_torch.utils.graphs import GraphCaptureError

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_align import _icp_pair  # noqa: E402
from test_torch_graphs import stub_cuda  # noqa: E402,F401 (fixture)
from test_torch_render import TI, mesh_db, poses  # noqa: E402

# the module: the package attribute `align.icp` is the function
ICP = sys.modules["visma_tpu_torch.align.icp"]
EIG3 = sys.modules["visma_tpu_torch.align.eig3"]


@pytest.fixture(params=["lapack", "jacobi"])
def linalg_form(request, monkeypatch):
    """The CPU's LAPACK `svd` / `eigh`, or the card's capturable
    `kabsch_rotation` / `sym3_eigh` on the CPU."""
    if request.param == "jacobi":
        monkeypatch.setattr(EIG3, "capturable", lambda t: True)
    return request.param


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svd_rotation(M):
    """U diag(1, 1, d) V^T of M's float64 SVD, d = sign(det(U) det(V))."""
    U, _, Vt = np.linalg.svd(np.asarray(M, np.float64))
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


def _matrices(kind, n=200, seed=0):
    """n float32 3x3 matrices of one kind, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        U = Rotation.random(random_state=rng).as_matrix()
        V = Rotation.random(random_state=rng).as_matrix()
        if kind == "random":
            M = rng.normal(size=(3, 3))
        elif kind == "near_rank_deficient":      # a planar point set
            M = U @ np.diag([1.0, rng.uniform(0.05, 1.0),
                             1e-7 * rng.random()]) @ V.T
        elif kind == "reflection":
            M = rng.normal(size=(3, 3))
            M = M if np.linalg.det(M) < 0 else -M
        elif kind == "near_isotropic":           # a cube's cross-covariance
            M = 2.0 * U + 1e-6 * rng.normal(size=(3, 3))
        else:                                    # two equal singular values
            M = U @ np.diag([1.0, 1.0 - 1e-6, rng.uniform(0.1, 0.9)]) @ V.T
        out.append(M)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("kind", ["random", "near_rank_deficient",
                                  "reflection", "near_isotropic",
                                  "clustered"])
def test_kabsch_rotation_matches_float64(kind):
    """The Umeyama rotation without an SVD against U diag(1, 1, d) V^T of
    NumPy's float64 SVD: 1e-5 on every entry, a batch and one at a time;
    the zero matrix gives the identity (the SVD's answer there)."""
    M = _matrices(kind)
    want = np.stack([_svd_rotation(m) for m in M])
    got = kabsch_rotation(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(kabsch_rotation(torch.as_tensor(M[7])),
                               want[7], atol=1e-5)
    np.testing.assert_array_equal(kabsch_rotation(torch.zeros(3, 3)),
                                  np.eye(3))


class _NoReadback(TorchDispatchMode):
    """Raises on any op that reads a tensor's value back to the host
    (`Tensor.item`, an index by a 0-d tensor, a data-dependent shape),
    which a CUDA graph capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.nonzero.default):
            raise AssertionError(f"{func} reads back to the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("shape", [(3, 3), (5, 3, 3)])
def test_eig3_reads_nothing_back(shape):
    """kabsch_rotation and sym3_eigh, one matrix and a batch, on the
    random, rank-1 and zero matrices: no op reads a value back to the host
    (the card captures them into ICP's graph)."""
    rng = np.random.default_rng(6)
    M = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=shape[:-1]), dtype=torch.float32)
    for m in (M, u[..., :, None] * u[..., None, :], torch.zeros(shape)):
        with _NoReadback():
            kabsch_rotation(m)
            sym3_eigh(m @ m.mT)


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_body_reads_nothing_back(point_to_plane, monkeypatch):
    """One ICP iteration and one normals chunk with the card's Jacobi
    forms: no op reads a value back to the host."""
    monkeypatch.setattr(EIG3, "capturable", lambda t: True)
    src, dst = (torch.as_tensor(x) for x in _icp_pair(point_to_plane))
    sv = torch.ones(len(src), dtype=torch.bool)
    dv = torch.ones(len(dst), dtype=torch.bool)
    n = (_estimate_normals(dst, dv, graph=False) if point_to_plane
         else torch.zeros_like(dst))
    state = (torch.eye(4), src, sv, dst, dv, n, torch.full((), 0.09))
    with _NoReadback():
        ICP._icp_body(point_to_plane, state, None)
        ICP._normals_body(12, (dst, torch.sum(dst * dst, dim=1)), dst[:64])


@pytest.mark.parametrize("kind", ["random", "near_identity", "clustered"])
def test_sym3_eigh_matches_float64(kind):
    """Eigenvalues within 1e-12 of the largest of NumPy's float64 `eigh`,
    V diag(w) V^T back to A and V orthonormal within 1e-12, and each
    simple eigenvalue's eigenvector parallel to NumPy's (sign free) within
    1e-9."""
    rng = np.random.default_rng(3)
    A = []
    for _ in range(300):
        Q = Rotation.random(random_state=rng).as_matrix()
        w = {"random": rng.uniform(0, 2, 3),
             "near_identity": 1.0 + 1e-8 * rng.normal(size=3),
             "clustered": np.array([1.0, 1.0 + 1e-9, 3.0])}[kind]
        A.append(Q @ np.diag(w) @ Q.T)
    A = np.asarray(A)
    w, V = (x.numpy() for x in sym3_eigh(torch.as_tensor(A)))
    wn, Vn = np.linalg.eigh(A)
    scale = np.abs(wn).max(axis=1, keepdims=True)
    assert (np.abs(w - wn) <= 1e-12 * scale).all()
    back = V @ (w[..., None] * np.swapaxes(V, 1, 2))
    assert (np.abs(back - A).max(axis=(1, 2)) <= 1e-12 * scale[:, 0]).all()
    np.testing.assert_allclose(np.swapaxes(V, 1, 2) @ V,
                               np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-12)
    for k in range(3):
        sep = np.abs(wn[:, [k]] - np.delete(wn, k, axis=1)).min(axis=1)
        simple = sep > 1e-3 * scale[:, 0]
        dots = np.abs(np.sum(V[:, :, k] * Vn[:, :, k], axis=1))
        assert (dots[simple] > 1 - 1e-9).all()


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_graph_equals_eager_and_jax(point_to_plane, linalg_form):
    """Both variants on a padded target (test_icp_matches_jax's pair),
    with either linear-algebra form: graph and eager give the same bytes;
    both within that test's tolerances of the JAX package (transformation
    1e-4, the same correspondence count, fitness and rmse 1e-5)."""
    src, dst = _icp_pair(point_to_plane)
    pad = np.concatenate([dst, np.zeros((100, 3), np.float32)])
    dv = np.ones(len(pad), bool)
    dv[::5] = False
    dv[len(dst):] = False
    kw = dict(max_distance=0.3, max_iters=20, point_to_plane=point_to_plane)
    rj = JA.icp(src, pad, target_valid=jnp.asarray(dv), **kw)
    eager = TA.icp(src, pad, target_valid=dv, device="cpu", graph=False, **kw)
    graphed = TA.icp(src, pad, target_valid=dv, device="cpu", graph=True,
                     **kw)
    np.testing.assert_array_equal(graphed.transformation,
                                  eager.transformation)
    assert (graphed.fitness, graphed.inlier_rmse, graphed.correspondences) \
        == (eager.fitness, eager.inlier_rmse, eager.correspondences)
    np.testing.assert_allclose(graphed.transformation, rj.transformation,
                               atol=1e-4)
    assert graphed.correspondences == rj.correspondences > 300
    assert abs(graphed.fitness - rj.fitness) < 1e-5
    assert abs(graphed.inlier_rmse - rj.inlier_rmse) < 1e-5


def test_normals_graph_equals_eager_and_jax(linalg_form):
    """test_estimate_normals_matches_jax's surface and chunk (301 points,
    128 a chunk: the last one padded), with either linear-algebra form:
    graph and eager the same bytes, each normal within |dot| > 1 - 1e-5 of
    the reference's."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (301, 2))
    z = 0.2 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    valid = np.ones(301, bool)
    valid[::17] = False
    nj = np.asarray(j_normals(jnp.asarray(pts), jnp.asarray(valid), k=12,
                              chunk=128))
    args = (torch.as_tensor(pts), torch.as_tensor(valid))
    ne = _estimate_normals(*args, k=12, chunk=128, graph=False)
    ng = _estimate_normals(*args, k=12, chunk=128, graph=True)
    np.testing.assert_array_equal(ng.numpy(), ne.numpy())
    assert (np.abs(np.sum(ng.numpy() * nj, axis=1)) > 1 - 1e-5).all()


def test_icp_graphs_lru(monkeypatch):
    """One StepGraph per variant and shape, at most `_CACHE_SIZE` of them:
    the least recently used is dropped, a repeat shape reuses its own;
    `release_graphs` drops them all."""
    monkeypatch.setattr(ICP, "_RUNS", OrderedDict())
    rng = np.random.default_rng(2)
    dst = rng.normal(size=(40, 3)).astype(np.float32)
    for n in range(10, 10 + ICP._CACHE_SIZE + 1):
        TA.icp(dst[:n] + 0.01, dst, 0.5, max_iters=2, device="cpu",
               graph=True)
    keys = list(ICP._RUNS)
    assert len(keys) == ICP._CACHE_SIZE
    assert ("icp", False, 10, 40) not in ICP._RUNS
    first = ICP._RUNS[keys[0]]
    TA.icp(dst[:keys[0][2]] + 0.01, dst, 0.5, max_iters=2, device="cpu",
           graph=True)
    assert ICP._RUNS[keys[0]] is first and list(ICP._RUNS)[-1] == keys[0]
    ICP.release_graphs()
    assert not ICP._RUNS


def test_icp_captures_once_per_shape(stub_cuda, monkeypatch):
    """On stand-in streams and graphs: the first ICP of a shape captures
    its iteration once (two eager warm-ups first), later calls of that
    shape and every other max_distance / initial pose replay it; the
    annotation tool's yaw sweep captures once over its 24 yaws."""
    monkeypatch.setattr(ICP, "_RUNS", OrderedDict())
    src, dst = _icp_pair(False)
    for d in (0.3, 0.2, 0.3):
        TA.icp(src, dst, d, max_iters=4, device="cpu", graph=True)
    assert [r.captures for r in ICP._RUNS.values()] == [1]

    monkeypatch.setattr(ICP, "_RUNS", OrderedDict())
    scene = (src @ Rotation.from_euler("z", 2.4).as_matrix().T
             ).astype(np.float32)
    TA.register_model_to_scene(src, scene, num_yaw=24, max_distance=0.1,
                               voxel=0.05, device="cpu", graph=True)
    assert [r.captures for r in ICP._RUNS.values()] == [1]


@pytest.mark.parametrize("form", ["_pm_dist", "_pm_dist_aos"])
def test_surface_distance_graph_equals_eager(form, monkeypatch):
    """2,500 points (not a whole number of 1,024-row chunks) against the
    300-face table: graph and eager the same bytes, both equal to the
    points taken 300 at a time (a row's answer does not depend on its
    chunk), and one StepGraph for every point count, which
    `release_graphs` drops."""
    monkeypatch.setattr(TM, "_RUNS", OrderedDict())
    fn = getattr(TM, form)
    V, F = mesh_db()["table"]
    V = torch.as_tensor(V, dtype=torch.float32)
    F = torch.as_tensor(np.asarray(F), dtype=torch.int64)
    A, B, C = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    rng = np.random.default_rng(4)
    P = torch.as_tensor(rng.uniform(-0.6, 0.6, (2500, 3)), dtype=torch.float32)
    eager = fn(P, A, B, C, graph=False)
    graphed = fn(P, A, B, C, graph=True)
    assert eager.shape == (2500,)
    np.testing.assert_array_equal(graphed.numpy(), eager.numpy())
    pieces = torch.cat([fn(c, A, B, C, graph=True)
                        for c in torch.split(P, 300)])
    np.testing.assert_array_equal(pieces.numpy(), eager.numpy())
    assert len(TM._RUNS) == 1
    TM.release_graphs()
    assert not TM._RUNS


def _multi():
    tr = TR.MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(mesh_db())
    return tr


def test_multi_renderer_graph_equals_eager_and_set_stack():
    """MultiMeshRenderer.render_depth through its CallGraph against the
    eager render, the same bytes, twice (the second call on the graph's
    buffers); after `set_stack` with other meshes the graph is dropped and
    the next graphed render is the new stack's, not the old one's."""
    tr = _multi()
    p, mi = poses(3, 5), np.array([0, 1, 0])
    eager = tr.render_depth(p, mi, graph=False)
    for _ in range(2):
        np.testing.assert_array_equal(tr.render_depth(p, mi, graph=True),
                                      eager)
    old = tr._depth_graph
    db = {k: (np.asarray(V) * 1.3, F) for k, (V, F) in mesh_db().items()}
    Vs, Fs = TR.pad_mesh_stack([db[n] for n in tr.names])
    tr.set_stack(Vs, Fs)
    assert "_depth_graph" not in tr.__dict__
    new = tr.render_depth(p, mi, graph=True)
    assert tr._depth_graph is not old
    np.testing.assert_array_equal(new, tr.render_depth(p, mi, graph=False))
    assert not np.array_equal(new, eager)


def test_renderer_graph_equals_eager_and_set_mesh():
    """Renderer.render_depth the same way; `set_mesh` drops the graph."""
    db = mesh_db()
    r = TR.Renderer(TI, device="cpu")
    r.set_mesh(*db["ball"])
    p = poses(4, 6)
    eager = r.render_depth(p, graph=False)
    for _ in range(2):
        np.testing.assert_array_equal(r.render_depth(p, graph=True), eager)
    assert r._depth_graph is not None
    r.set_mesh(*db["table"])
    assert r._depth_graph is None
    new = r.render_depth(p, graph=True)
    np.testing.assert_array_equal(new, r.render_depth(p, graph=False))
    assert not np.array_equal(new, eager)


def test_graphed_render_inside_a_capture_raises(monkeypatch):
    """A graphed render entered while a capture is running raises
    GraphCaptureError (captures cannot nest), and so does a graphed ICP;
    the eager forms run."""
    tr = _multi()
    p, mi = poses(2, 7), np.array([1, 0])
    monkeypatch.setattr(graphs, "capturing", lambda device: True)
    with pytest.raises(GraphCaptureError, match="cannot nest"):
        tr.render_depth(p, mi, graph=True)
    r = TR.Renderer(TI, device="cpu")
    r.set_mesh(*mesh_db()["ball"])
    with pytest.raises(GraphCaptureError, match="cannot nest"):
        r.render_depth(p, graph=True)
    src, dst = _icp_pair(False)
    with pytest.raises(GraphCaptureError, match="cannot nest"):
        TA.icp(src, dst, 0.3, max_iters=2, device="cpu", graph=True)
    assert tr.render_depth(p, mi, graph=False).shape == (2, 96, 128)
