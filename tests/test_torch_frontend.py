"""Parity of the PyTorch port's frontend (visma_tpu_torch.frontend, .image)
with the JAX reference on the CPU. The reference's Pallas kernels run in
interpret mode, as its own tests run them; the port's kernel wrappers take
their plain PyTorch versions for CPU tensors. Tolerances are stated per
test."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

import visma_tpu.frontend.klt_fused as JKF
import visma_tpu.frontend.tracker as JTR
from visma_tpu.frontend import klt as JK
from visma_tpu.frontend.detect import (_corner_score_xla, corner_score_pallas,
                                       detect_features as j_detect)
from visma_tpu.frontend.pyramid import build_pyramid as j_pyramid

from visma_tpu_torch.frontend import detect as tdet, klt as tk, klt_fused as tkf
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.frontend.tracker import FeatureTracker, occupied_cells


def textured_image(H=128, W=160, seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H // 8, W // 8)).astype(np.float32)
    return cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC)


def shift_image(img, dx, dy):
    import cv2

    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, M, (img.shape[1], img.shape[0]),
                          flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def interpret_tracker(monkeypatch):
    """The JAX fused tracker on the CPU: its LK kernel in interpret mode
    (as tests/test_frontend.py::test_tracker_fused_flag runs it)."""
    orig = JKF.track_features_fused

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(JTR, "track_features_fused", interp)


class TestPyramid:
    @pytest.mark.parametrize("shape", [(128, 160), (125, 75)])
    def test_matches_jax(self, shape):
        """Same four taps in the same order and a power-of-two scale:
        equal to 1e-5 on a 0-255 image; odd sizes floor (125 -> 62 -> 31)."""
        img = textured_image(128, 160)[:shape[0], :shape[1]]
        ref = j_pyramid(jnp.asarray(img), 3)
        got = build_pyramid(_t(img), 3)
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)


class TestCornerScore:
    def test_plain_matches_xla(self):
        """The plain twin follows _corner_score_xla everywhere: 1e-4 of the
        largest score (TestDetectPallas's tolerance)."""
        img = textured_image()
        ref = np.asarray(_corner_score_xla(jnp.asarray(img), 5, 8, 1e-4))
        got = _np(tdet.corner_score_plain(_t(img), 5, 8, 1e-4))
        np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, ref.max()))

    def test_plain_matches_pallas_inside_mask(self):
        """Against the TPU kernel itself (interpret mode). The two differ
        only at the frame edge, which the border mask (8 >= 4 px) zeroes,
        so the whole masked map is compared at the same tolerance."""
        img = textured_image(seed=4)
        ref = np.asarray(corner_score_pallas(jnp.asarray(img), 5, 8, 1e-4,
                                             interpret=True))
        got = _np(tdet.corner_score_plain(_t(img), 5, 8, 1e-4))
        np.testing.assert_allclose(got, ref, atol=1e-4 * max(1.0, ref.max()))

    def test_cpu_tensor_takes_plain_version(self):
        img = _t(textured_image())
        before = tdet.corner_score.launches
        np.testing.assert_array_equal(_np(tdet.corner_score(img)),
                                      _np(tdet.corner_score_plain(img)))
        assert tdet.corner_score.launches == before


def _tie_image():
    """Identical step corners: one per cell in many cells (equal cell
    scores, more cells than features), and two identical corners in one
    cell (equal scores inside a cell)."""
    img = np.zeros((96, 128), np.float32)
    for cy in range(1, 5):
        for cx in range(1, 7):
            y, x = cy * 16 + 6, cx * 16 + 6
            img[y:y + 5, x:x + 5] = 100.0
    img[66:71, 100:105] = 100.0       # second corner square in cell (4, 6)
    return img


class TestDetect:
    @pytest.mark.parametrize("max_features", [8, 40])
    def test_ties_match_jax(self, max_features):
        """Equal scores: the per-cell winner is the last maximal linear
        index and the global order is lowest cell index first, as
        lax.top_k. Positions and validity equal, scores to 1e-4 relative."""
        img = _tie_image()
        xj, sj, vj = j_detect(jnp.asarray(img), max_features, cell=16,
                              use_pallas=False)
        xt, st, vt = tdet.detect_features(_t(img), max_features, cell=16)
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
        np.testing.assert_array_equal(_np(xt), np.asarray(xj))
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=1e-4)
        assert len(set(np.round(np.asarray(sj)[np.asarray(vj)], 3))) \
            < np.asarray(vj).sum()   # the fixture really has ties

    def test_occupied_and_padding_match_jax(self):
        """Occupied cells skipped; more features asked than cells exist
        pads with invalid zeros."""
        img = textured_image()
        occ = np.zeros((8, 10), bool)
        occ[::2, 1::3] = True
        xj, sj, vj = j_detect(jnp.asarray(img), 96, cell=16,
                              occupied=jnp.asarray(occ), use_pallas=False)
        xt, st, vt = tdet.detect_features(_t(img), 96, cell=16,
                                          occupied=_t(occ))
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
        np.testing.assert_array_equal(_np(xt), np.asarray(xj))
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=1e-4)


def _cell_oracle(score, cell):
    """Loop oracle of the per-cell pick: per cell, the best score among
    pixels > 0 (0 if none) and the last linear index row * Wc + col that
    holds it (-1 if none), walking the cell in row-major order."""
    H, W = score.shape
    gh, gw = H // cell, W // cell
    Wc = gw * cell
    best = np.zeros((gh, gw), np.float32)
    idx = np.full((gh, gw), -1, np.int32)
    for cy in range(gh):
        for cx in range(gw):
            for y in range(cy * cell, (cy + 1) * cell):
                for x in range(cx * cell, (cx + 1) * cell):
                    v = score[y, x]
                    if v > 0 and v >= best[cy, cx]:
                        best[cy, cx], idx[cy, cx] = v, y * Wc + x
    return best, idx


class TestCellBest:
    @settings(max_examples=30, deadline=None)
    @given(data=st.data(), cell=st.sampled_from([12, 16, 32]))
    def test_matches_loop_oracle(self, data, cell):
        """Score maps full of ties and zeros (values from a five-element
        set), H and W not multiples of the cell."""
        H = data.draw(st.integers(cell, 3 * cell + 7), label="H")
        W = data.draw(st.integers(cell, 3 * cell + 7), label="W")
        seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
        rng = np.random.default_rng(seed)
        score = rng.choice(np.float32([0.0, 0.0, 0.25, 1.5, 3.0, -1.0]),
                           size=(H, W)).astype(np.float32)
        best, idx = tdet.cell_best_plain(_t(score), cell)
        ref_best, ref_idx = _cell_oracle(score, cell)
        np.testing.assert_array_equal(_np(best), ref_best)
        np.testing.assert_array_equal(_np(idx), ref_idx)

    @pytest.mark.parametrize("cell", [12, 16, 32])
    def test_corner_cells_on_the_cpu(self, cell):
        """corner_cells on a CPU tensor: the plain map, its cell picks and
        their pixel coordinates, as detect_features takes them."""
        img = textured_image(100, 150, seed=4)
        score, best, idx, xy = tdet.corner_cells(_t(img), cell)
        np.testing.assert_array_equal(
            _np(score), _np(tdet.corner_score_plain(_t(img))))
        ref_best, ref_idx = _cell_oracle(_np(score), cell)
        np.testing.assert_array_equal(_np(best), ref_best)
        np.testing.assert_array_equal(_np(idx), ref_idx)
        Wc = (150 // cell) * cell
        flat = np.maximum(ref_idx, 0)
        np.testing.assert_array_equal(_np(xy), np.stack(
            [flat % Wc, flat // Wc], -1).astype(np.float32))

    @pytest.mark.parametrize("cell", [12, 32])
    def test_detect_features_matches_jax_at_other_cells(self, cell):
        img = textured_image(seed=5)
        xj, sj, vj = j_detect(jnp.asarray(img), 40, cell=cell,
                              use_pallas=False)
        xt, st_, vt = tdet.detect_features(_t(img), 40, cell=cell)
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
        np.testing.assert_array_equal(_np(xt), np.asarray(xj))
        np.testing.assert_allclose(_np(st_), np.asarray(sj), rtol=1e-4)


def _lk_problem(win=24, r=5, seed=0):
    """Level-0 LK inputs as track_features_fused builds them, with a
    perturbed search guess and features near the frame edge (clamps)."""
    img0 = textured_image(seed=seed)
    img1 = shift_image(img0, 3.4, -2.1)
    xy, _, valid = j_detect(jnp.asarray(img0), 24, cell=16, border=8,
                            use_pallas=False)
    pts = np.asarray(xy)[np.asarray(valid)]
    pts = np.concatenate([pts, [[3.0, 4.5], [150.5, 120.25]]]).astype(np.float32)
    est = (pts + [2.9, -1.7]).astype(np.float32)
    return img0, img1, pts, est


class TestLkLevel:
    def test_plain_matches_pallas(self):
        """lk_level_plain reading the level images directly against
        lk_level_fused (interpret) on windows from _extract_windows_klast:
        displacement and residual to 1e-4, ok equal."""
        win, r = 24, 5
        img0, img1, pts, est = _lk_problem()
        wP, oP = JKF._extract_windows_klast(jnp.asarray(img0), jnp.asarray(pts), win)
        wC, oC = JKF._extract_windows_klast(jnp.asarray(img1), jnp.asarray(est), win)
        stT = (pts - r - np.asarray(oP, np.float32)).T[::-1]
        sI0 = (est - r - np.asarray(oC, np.float32)).T[::-1]
        uj, rj, okj = JKF.lk_level_fused(wP, wC, jnp.asarray(stT),
                                         jnp.asarray(sI0), radius=r,
                                         interpret=True)
        H, W = img0.shape
        oPt = tkf.window_origin(_t(pts), win, H, W)
        oCt = tkf.window_origin(_t(est), win, H, W)
        np.testing.assert_array_equal(_np(oPt), np.asarray(oP))
        np.testing.assert_array_equal(_np(oCt), np.asarray(oC))
        ut, rt, okt = tkf.lk_level(_t(img0), _t(img1), oPt, oCt, _t(stT),
                                   _t(sI0), win, r)
        np.testing.assert_array_equal(_np(okt), np.asarray(okj))
        np.testing.assert_allclose(_np(ut), np.asarray(uj), atol=1e-4)
        np.testing.assert_allclose(_np(rt), np.asarray(rj), atol=1e-4)

    def test_small_window_raises(self):
        img = torch.zeros(16, 16)
        org = torch.zeros((2, 2), dtype=torch.int32)
        st = torch.zeros((2, 2))
        with pytest.raises(ValueError, match="too small"):
            tkf.lk_level(img, img, org, org, st, st, 8, radius=5)

    @pytest.mark.parametrize("shift", [(3.4, -2.1), (9.5, 6.0)])
    def test_track_features_fused_matches_jax(self, shift):
        """Whole pyramidal track (3 levels + forward-backward) against the
        JAX fused tracker in interpret mode: positions to 1e-4 px, ok
        equal."""
        img0 = textured_image(seed=2)
        img1 = shift_image(img0, *shift)
        xy, _, valid = j_detect(jnp.asarray(img0), 24, cell=16,
                                use_pallas=False)
        pj = tuple(j_pyramid(jnp.asarray(img0), 3))
        cj = tuple(j_pyramid(jnp.asarray(img1), 3))
        nj, okj = JKF.track_features_fused(pj, cj, xy, valid, interpret=True)
        nt, okt = tkf.track_features_fused(
            tuple(build_pyramid(_t(img0), 3)), tuple(build_pyramid(_t(img1), 3)),
            _t(xy), _t(valid))
        np.testing.assert_array_equal(_np(okt), np.asarray(okj))
        assert np.asarray(okj).sum() >= 8
        np.testing.assert_allclose(_np(nt), np.asarray(nj), atol=1e-4)


class TestLkTrack:
    """`lk_track_plain`, the plain version of the one-launch track kernel
    and what `track_features_fused` runs on CPU tensors."""

    @staticmethod
    def _problem(shape, shift, seed=2):
        img0 = textured_image(seed=seed)[:shape[0], :shape[1]].copy()
        img1 = shift_image(img0, *shift)
        xy, _, valid = j_detect(jnp.asarray(img0), 24, cell=16,
                                use_pallas=False)
        return img0, img1, np.asarray(xy), np.asarray(valid)

    @pytest.mark.parametrize("levels,shape,shift", [
        (1, (128, 160), (1.4, -0.9)), (2, (128, 160), (3.4, -2.1)),
        (3, (128, 160), (3.4, -2.1)), (4, (128, 160), (9.5, 6.0)),
        (4, (96, 112), (3.4, -2.1))])
    def test_plain_matches_jax(self, levels, shape, shift):
        """1 to 4 levels + forward-backward against the JAX fused tracker
        in interpret mode: positions to 1e-4 px, ok equal. The (96, 112)
        pyramid's top level (12 x 14) is too small and skipped by both."""
        img0, img1, xy, valid = self._problem(shape, shift)
        pj = tuple(j_pyramid(jnp.asarray(img0), levels))
        cj = tuple(j_pyramid(jnp.asarray(img1), levels))
        nj, okj = JKF.track_features_fused(pj, cj, jnp.asarray(xy),
                                           jnp.asarray(valid), levels=levels,
                                           interpret=True)
        pt = tuple(build_pyramid(_t(img0), levels))
        ct = tuple(build_pyramid(_t(img1), levels))
        skipped = [w == 0 for _, _, w in tkf.level_windows(pt, levels, 5, 24)]
        assert skipped == [False] * 3 + [True] if shape == (96, 112) \
            else not any(skipped)
        nt, okt = tkf.lk_track_plain(pt, ct, _t(xy), _t(valid), levels=levels)
        np.testing.assert_array_equal(_np(okt), np.asarray(okj))
        assert np.asarray(okj).sum() >= 6
        np.testing.assert_allclose(_np(nt), np.asarray(nj), atol=1e-4)
        # the dispatch: CPU tensors take the plain version, no launch
        before = tkf.lk_track.launches
        nf, okf = tkf.track_features_fused(pt, ct, _t(xy), _t(valid),
                                           levels=levels)
        assert tkf.lk_track.launches == before
        np.testing.assert_array_equal(_np(nf), _np(nt))
        np.testing.assert_array_equal(_np(okf), _np(okt))

    def test_invalid_features_come_back_unchanged(self):
        """A feature that is not valid keeps its position with ok false,
        and does not change what the others get."""
        img0, img1, xy, valid = self._problem((128, 160), (3.4, -2.1))
        pt = tuple(build_pyramid(_t(img0), 3))
        ct = tuple(build_pyramid(_t(img1), 3))
        some = valid.copy()
        some[::3] = False
        n_all, ok_all = tkf.lk_track_plain(pt, ct, _t(xy), _t(valid))
        n_some, ok_some = tkf.lk_track_plain(pt, ct, _t(xy), _t(some))
        off = ~some
        assert not _np(ok_some)[off].any()
        np.testing.assert_array_equal(_np(n_some)[off], xy[off])
        np.testing.assert_array_equal(_np(ok_some)[some], _np(ok_all)[some])
        np.testing.assert_array_equal(_np(n_some)[some], _np(n_all)[some])
        assert _np(ok_some).sum() >= 6

    def test_no_features(self):
        img0, img1, xy, valid = self._problem((128, 160), (3.4, -2.1))
        pt = tuple(build_pyramid(_t(img0), 3))
        ct = tuple(build_pyramid(_t(img1), 3))
        for fn in (tkf.lk_track_plain, tkf.lk_track,
                   tkf.track_features_fused):
            n, ok = fn(pt, ct, _t(xy[:0]), _t(valid[:0]))
            assert n.shape == (0, 2) and ok.shape == (0,) \
                and ok.dtype == torch.bool

    @pytest.mark.parametrize("shape,levels", [((96, 112), 4), ((100, 75), 4),
                                              ((500, 960), 4), ((64, 64), 1)])
    def test_level_table(self, shape, levels):
        """The table the wrapper packs for the kernel: per level the
        image pointers, the sizes, and the window
        min(win, Hl - Hl%8 or Hl, Wl - Wl%8 or Wl) of the reference
        (klt_fused.py:222), 0 where it is below 2r+4 (:223-227)."""
        r, win = 5, 24
        prev = build_pyramid(torch.zeros(shape), levels)
        cur = build_pyramid(torch.ones(shape), levels)
        table = tkf.pack_levels(prev, cur, levels, r, win)
        assert table.n == levels
        for lv in range(levels):
            Hl, Wl = prev[lv].shape
            wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
            want = wl if wl >= 2 * r + 4 else 0
            assert (table.H[lv], table.W[lv], table.wl[lv]) == (Hl, Wl, want)
            assert table.prev[lv] == prev[lv].data_ptr()
            assert table.cur[lv] == cur[lv].data_ptr()
        assert table.wl[0] > 0
        if shape in ((96, 112), (100, 75)):
            assert table.wl[levels - 1] == 0      # the top level is skipped
        assert all(table.wl[lv] == 0 and table.prev[lv] is None
                   for lv in range(levels, tkf.MAX_LEVELS))

    def test_level_table_refusals(self):
        img = torch.zeros(64, 64)
        pyr = build_pyramid(img, 2)
        with pytest.raises(ValueError, match="levels"):
            tkf.pack_levels(pyr, pyr, 3, 5, 24)
        with pytest.raises(ValueError, match="levels"):
            tkf.pack_levels(pyr, pyr, tkf.MAX_LEVELS + 1, 5, 24)
        with pytest.raises(ValueError, match="contiguous"):
            tkf.pack_levels(pyr, [img, torch.zeros(32, 64)[:, ::2]], 2, 5, 24)
        with pytest.raises(ValueError, match="float32"):
            tkf.pack_levels(pyr, [img.double(), pyr[1]], 2, 5, 24)
        tiny = [torch.zeros(12, 12)]
        with pytest.raises(ValueError, match="too small"):
            tkf.pack_levels(tiny, tiny, 1, 5, 24)
        with pytest.raises(ValueError, match="too small"):
            tkf.track_features_fused(tiny, tiny, torch.zeros(1, 2),
                                     torch.ones(1, dtype=torch.bool),
                                     levels=1)


class TestKltWindowed:
    """The windowed tracker (frontend/klt.py), plain PyTorch on both the CPU
    and the card: direct indexing in place of the reference's one-hot
    selection matmuls."""

    @pytest.mark.parametrize("name", ["track_features",
                                      "track_features_gather"])
    @pytest.mark.parametrize("shift", [(3.4, -2.1), (9.5, 6.0)])
    def test_matches_jax(self, name, shift):
        """3 levels + forward-backward against the reference's function of
        the same name: positions to 1e-4 px (measured 1.5e-5), ok equal."""
        img0 = textured_image(seed=2)
        img1 = shift_image(img0, *shift)
        xy, _, valid = j_detect(jnp.asarray(img0), 24, cell=16,
                                use_pallas=False)
        nj, okj = getattr(JK, name)(
            tuple(j_pyramid(jnp.asarray(img0), 3)),
            tuple(j_pyramid(jnp.asarray(img1), 3)), xy, valid)
        nt, okt = getattr(tk, name)(
            tuple(build_pyramid(_t(img0), 3)), tuple(build_pyramid(_t(img1), 3)),
            _t(xy), _t(valid))
        np.testing.assert_array_equal(_np(okt), np.asarray(okj))
        assert np.asarray(okj).sum() >= 8
        np.testing.assert_allclose(_np(nt), np.asarray(nj), atol=1e-4)

    def test_window_origins_round_half_to_even(self):
        """round(centre) - win//2 clipped to the image, as
        klt.py::_extract_windows; centres on .5 round to even."""
        img = jnp.zeros((64, 80))
        c = np.array([[10.5, 11.5], [0.2, 63.9], [79.0, 30.49], [39.5, 40.5]],
                     np.float32)
        _, org = JK._extract_windows(img, jnp.asarray(c), 24)
        np.testing.assert_array_equal(
            _np(tk._extract_origins(_t(c), 24, 64, 80)), np.asarray(org))

    def test_small_window_raises(self):
        pyr = (torch.zeros(16, 16), torch.zeros(8, 8))
        pts = torch.full((2, 2), 6.0)
        with pytest.raises(ValueError, match="too small"):
            tk.track_features(pyr, pyr, pts, torch.ones(2, dtype=torch.bool),
                              levels=2)


class TestTracker:
    def test_occupied_duplicates_last_slot_wins(self):
        """`zeros.at[cy, cx].set(ok)` with duplicate cells, as JAX on the
        CPU applies it (highest slot index wins)."""
        rng = np.random.default_rng(0)
        pos = rng.uniform(-5, 70, (40, 2)).astype(np.float32)
        ok = rng.random(40) > 0.5
        cx = np.clip((pos[:, 0] / 16).astype(np.int32), 0, 3)
        cy = np.clip((pos[:, 1] / 16).astype(np.int32), 0, 2)
        ref = jnp.zeros((3, 4), bool).at[cy, cx].set(ok, mode="drop")
        got = occupied_cells(_t(pos), _t(ok), 16, 3, 4)
        np.testing.assert_array_equal(_np(got), np.asarray(ref))

    def test_windowed_steps_match_jax(self):
        """fused=False on both sides: the windowed tracker, the reference's
        default off the TPU. ids and validity equal per frame, positions
        to 1e-4 px."""
        img = textured_image(seed=3)
        jt = JTR.FeatureTracker(max_features=24, cell=16, fused=False)
        tt = FeatureTracker(max_features=24, cell=16, fused=False)
        assert not tt.fused and FeatureTracker().fused \
            and FeatureTracker(fused=True).fused
        js, ts = jt.init(jnp.asarray(img)), tt.init(_t(img))
        for k in range(3):
            img = shift_image(img, 3.0, -2.0)
            js, idj, xpj, vj = jt.step(js, jnp.asarray(img))
            ts, idt, xpt, vt = tt.step(ts, _t(img))
            np.testing.assert_array_equal(_np(idt), np.asarray(idj))
            np.testing.assert_array_equal(_np(vt), np.asarray(vj))
            np.testing.assert_allclose(_np(xpt), np.asarray(xpj), atol=1e-4)

    def test_steps_match_jax(self, interpret_tracker):
        """init + 3 steps of the fused tracker: ids and validity equal per
        frame, positions to 1e-4 px."""
        img = textured_image(seed=3)
        jt = JTR.FeatureTracker(max_features=24, cell=16, fused=True)
        tt = FeatureTracker(max_features=24, cell=16)
        js, ts = jt.init(jnp.asarray(img)), tt.init(_t(img))
        np.testing.assert_array_equal(_np(ts.ids), np.asarray(js.ids))
        step = jax.jit(jt._step_impl)
        for k in range(3):
            img = shift_image(img, 3.0, -2.0)
            js, idj, xpj, vj = step(js, jnp.asarray(img))
            ts, idt, xpt, vt = tt.step(ts, _t(img))
            np.testing.assert_array_equal(_np(idt), np.asarray(idj))
            np.testing.assert_array_equal(_np(vt), np.asarray(vj))
            np.testing.assert_allclose(_np(xpt), np.asarray(xpj), atol=1e-4)
            assert int(_np(ts.next_id)) == int(np.asarray(js.next_id))
