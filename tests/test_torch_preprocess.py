"""PyTorch port: host preprocessing (scaler, HDF5 ingestion, features, the
synthetic archive and the preprocess CLI) against the JAX package's.

The port's CLI and ``python -m tec_mollm_tpu.data.preprocess`` run on the same
arguments; every array of every ``.npz`` they write must be identical (same
dtype, same bits) and ``preprocess_meta.json`` the same text. Both packages
read each other's HDF5 files into identical splits. The functions in between
are held against JAX's on the same numpy inputs, exactly: both are the same
numpy arithmetic."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tec_mollm_tpu.data.features as jfeat
import tec_mollm_tpu.data.hdf5_io as jio
import tec_mollm_tpu.data.scaler as jscaler
import tec_mollm_tpu.data.synthetic as jsyn
import tec_mollm_tpu_torch.data.features as pfeat
import tec_mollm_tpu_torch.data.hdf5_io as pio
import tec_mollm_tpu_torch.data.scaler as pscaler
import tec_mollm_tpu_torch.data.synthetic as psyn
from tec_mollm_tpu_torch.data import preprocess as pprep

ROOT = Path(__file__).resolve().parent.parent
GRID = (6, 8)
# the CLI runs of the issue's acceptance: (label, extra flags)
CLI_CASES = {
    "plain": [],
    "solar": ["--solar-cycle"],
    "gap": ["--synthetic-drop", "200", "6", "--cadence-policy", "segment"],
}


def _run(module: str, args: list[str], block_h5py: bool = False) -> subprocess.CompletedProcess:
    """``python -m module args`` in a fresh interpreter (h5py importable or not)."""
    code = textwrap.dedent(f"""
        import runpy, sys
        if {block_h5py!r}:
            sys.modules["h5py"] = None  # any import of h5py now raises
        sys.argv = [{module!r}] + {args!r}
        runpy.run_module({module!r}, run_name="__main__")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def assert_same_dirs(a: Path, b: Path) -> None:
    """The same files; every .npz array identical in dtype and bits; the
    same metadata."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert {"graph.npz", "scaler.npz", "target_scaler.npz", "preprocess_meta.json"} <= set(names)
    for split in ("train", "val", "test"):
        assert {f"{split}_set.npz", f"{split}_raw.npz"} <= set(names)
    for name in names:
        if name.endswith(".json"):
            assert json.loads((a / name).read_text()) == json.loads((b / name).read_text()), name
            continue
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files), name
            for k in x.files:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (name, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name}:{k}")


class TestCLI:
    @pytest.mark.parametrize("case", list(CLI_CASES))
    def test_same_files_as_jax(self, tmp_path, case):
        """--synthetic 1200 on the 6 x 8 grid; the port's CLI with h5py
        blocked, as on a machine that has none."""
        args = ["--synthetic", "1200", "--synthetic-grid", *map(str, GRID), *CLI_CASES[case]]
        _run("tec_mollm_tpu.data.preprocess", args + ["--out", str(tmp_path / "jax")])
        _run("tec_mollm_tpu_torch.data.preprocess", args + ["--out", str(tmp_path / "port")], block_h5py=True)
        assert_same_dirs(tmp_path / "jax", tmp_path / "port")
        with np.load(tmp_path / "port" / "train_raw.npz") as raw:
            assert ("segment_id" in raw.files) == (case == "gap")

    def test_raw_dir_of_hdf5_files(self, tmp_path):
        """--raw-dir over JAX-written CRIM files of three years (one per split):
        both CLIs write the same files."""
        raw = tmp_path / "raw"
        raw.mkdir()
        pattern = "CRIM_SW2hr_AI_v1.2_{year}_DataDrivenRange_CN.hdf5"
        for year in (2020, 2022, 2024):
            jsyn.write_synthetic_hdf5(str(raw / pattern.format(year=year)), year=year, num_steps=80,
                                      grid_h=GRID[0], grid_w=GRID[1])
        args = ["--raw-dir", str(raw), "--horizon", "4"]
        _run("tec_mollm_tpu.data.preprocess", args + ["--out", str(tmp_path / "jax")])
        sizes = pprep.main(args + ["--out", str(tmp_path / "port")])
        assert sizes == {"train": 76, "val": 76, "test": 76}
        assert_same_dirs(tmp_path / "jax", tmp_path / "port")

    def test_no_archive_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="No HDF5 files"):
            pprep.main(["--raw-dir", str(tmp_path), "--out", str(tmp_path / "out")])


def _write_years(root: Path, writer, years=(2020, 2022, 2024)) -> list[str]:
    paths = []
    for year in years:
        p = root / f"{year}.h5"
        writer(str(p), year=year, num_steps=30, grid_h=GRID[0], grid_w=GRID[1])
        paths.append(str(p))
    return paths


def _assert_splits_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            assert np.asarray(got[name][k]).dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name}:{k}")


class TestHDF5:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_each_package_reads_the_others_files(self, tmp_path, writer):
        write = {"jax": jsyn.write_synthetic_hdf5, "port": psyn.write_synthetic_hdf5}[writer]
        paths = _write_years(tmp_path, write)
        _assert_splits_equal(pio.load_and_split_data(paths), jio.load_and_split_data(paths))

    def test_both_writers_write_the_same_data(self, tmp_path):
        (tmp_path / "j").mkdir()
        (tmp_path / "p").mkdir()
        a = jio.load_and_split_data(_write_years(tmp_path / "j", jsyn.write_synthetic_hdf5))
        b = pio.load_and_split_data(_write_years(tmp_path / "p", psyn.write_synthetic_hdf5))
        _assert_splits_equal(b, a)

    def test_missing_tec_names_path_and_file(self, tmp_path):
        import h5py

        path = tmp_path / "broken.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset("coordinates/datetime_utc", data=np.array([b"2020-01-01T00:00:00"]))
        with pytest.raises(KeyError, match=r"ionosphere/TEC.*broken\.h5"):
            pio.load_hdf5_file(str(path))

    def test_decode_and_cadence(self):
        times = np.array([b"2020-01-01T00:00:00", b"2020-01-01T02:00:00", b"2020-01-01T04:00:00",
                          b"2020-01-01T08:00:00"])
        got = pio.decode_times(times)
        np.testing.assert_array_equal(got, jio.decode_times(times))
        assert pio.check_cadence(got) == jio.check_cadence(got) == 1
        bad = np.array([False, True, False, False])
        np.testing.assert_array_equal(pio.compute_segments(got, bad), jio.compute_segments(got, bad))


class TestFeatures:
    def test_short_series_raises(self):
        with pytest.raises(ValueError, match="Need > 12 timesteps"):
            pfeat.construct_target_tensor(np.zeros((12, 2, 2), np.float32), horizon=12)

    @pytest.mark.parametrize("policy", ["warn", "raise", "segment"])
    def test_split_tensors_match_jax(self, policy):
        """A gapped archive: 'raise' refuses it in both packages, the other
        two policies build the same tensors (segment ids included)."""
        raw = jsyn.synthetic_raw_data(num_steps=400, grid_h=GRID[0], grid_w=GRID[1], seed=3)
        keep = np.ones(400, dtype=bool)
        keep[150:155] = False
        raw = {k: (v[keep] if k in ("tec", "time", "space_weather_indices") else v) for k, v in raw.items()}
        splits = pio.split_by_time(raw, "2014-01-20 23:59:59", "2014-01-21 00:00:00", "2014-01-28 23:59:59",
                                   "2014-01-29 00:00:00")
        jsplits = jio.split_by_time(raw, "2014-01-20 23:59:59", "2014-01-21 00:00:00", "2014-01-28 23:59:59",
                                    "2014-01-29 00:00:00")
        if policy == "raise":
            for fn, s in ((pfeat.build_split_tensors, splits), (jfeat.build_split_tensors, jsplits)):
                with pytest.raises(ValueError, match="irregularities"):
                    fn(s, horizon=4, cadence_policy=policy)
            return
        got = pfeat.build_split_tensors(splits, horizon=4, cadence_policy=policy)
        want = jfeat.build_split_tensors(jsplits, horizon=4, cadence_policy=policy)
        _assert_splits_equal(got, want)
        got, gsx = pfeat.standardize_features(got)
        want, jsx = jfeat.standardize_features(want)
        got, gsy = pfeat.standardize_targets(got)
        want, jsy = jfeat.standardize_targets(want)
        _assert_splits_equal(got, want)
        for a, b in ((gsx, jsx), (gsy, jsy)):
            np.testing.assert_array_equal(a.mean_, b.mean_)
            np.testing.assert_array_equal(a.scale_, b.scale_)

    def test_time_features_match_jax(self):
        times = np.datetime64("2019-12-31T20:00:00") + np.arange(50) * np.timedelta64(7200, "s")
        np.testing.assert_array_equal(pfeat.extract_time_features(times, 2013), jfeat.extract_time_features(times, 2013))
        np.testing.assert_array_equal(pfeat.extract_time_features(times), jfeat.extract_time_features(times))


class TestScaler:
    @pytest.mark.parametrize("dtype", [None, np.float32])
    def test_fit_and_transforms_match_jax(self, tmp_path, dtype, monkeypatch):
        """Chunked (4 rows a chunk here) fit, transform and fit_transform equal
        JAX's bit for bit; a zero-variance column scales by 1; the .npz reads
        back in the other package."""
        x = np.random.default_rng(0).normal(3.0, 2.0, size=(11, 3)).astype(np.float32)
        x[:, 2] = 7.0
        monkeypatch.setattr(pscaler.StandardScaler, "CHUNK_ROWS", 4)
        monkeypatch.setattr(jscaler.StandardScaler, "CHUNK_ROWS", 4)
        p, j = pscaler.StandardScaler().fit(x), jscaler.StandardScaler().fit(x)
        np.testing.assert_array_equal(p.mean_, j.mean_)
        np.testing.assert_array_equal(p.scale_, j.scale_)
        assert p.scale_[2] == 1.0
        np.testing.assert_array_equal(p.transform(x, dtype=dtype), j.transform(x, dtype=dtype))
        np.testing.assert_array_equal(pscaler.StandardScaler().fit_transform(x), j.fit_transform(x))
        p.save(str(tmp_path / "s.npz"))
        back = jscaler.StandardScaler.load(str(tmp_path / "s.npz"))
        np.testing.assert_array_equal(back.mean_, p.mean_)
        np.testing.assert_allclose(p.inverse_transform(p.transform(x)), x, rtol=1e-6)

    def test_unfitted_and_bad_shapes_raise(self):
        with pytest.raises(RuntimeError, match="not fitted"):
            pscaler.StandardScaler().transform(np.zeros((2, 2)))
        with pytest.raises(ValueError, match="2D"):
            pscaler.StandardScaler().fit(np.zeros(3))


class TestSynthetic:
    @pytest.mark.parametrize("solar", [False, True])
    def test_raw_data_matches_jax(self, solar):
        got = psyn.synthetic_raw_data(num_steps=300, grid_h=GRID[0], grid_w=GRID[1], seed=5, solar_cycle=solar)
        want = jsyn.synthetic_raw_data(num_steps=300, grid_h=GRID[0], grid_w=GRID[1], seed=5, solar_cycle=solar)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for a, b in zip(psyn.grid_coordinates(*GRID), jsyn.grid_coordinates(*GRID)):
            np.testing.assert_array_equal(a, b)
