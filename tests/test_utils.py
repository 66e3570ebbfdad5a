"""Utils tests: logger, config, dtype machinery (parity:
tests/suites/sparsebase/utils/*)."""

import numpy as np
import pytest

from sparsebase_tpu.config import get_config, set_config
from sparsebase_tpu.utils import (
    LOG_LVL_INFO,
    LOG_LVL_NONE,
    LOG_LVL_WARNING,
    Logger,
    can_dtype_fit,
    convert_array_dtype,
    index_dtype_for,
)
from sparsebase_tpu.utils.exceptions import TypeMismatchError


class TestLogger:
    def test_levels_filter(self, capsys):
        Logger.set_level(LOG_LVL_WARNING)
        log = Logger("TestRoot")
        log.info("quiet")
        log.warning("loud")
        out = capsys.readouterr().out
        assert "quiet" not in out
        assert "loud" in out and "TestRoot" in out and "WARNING" in out

    def test_none_level_silences(self, capsys):
        Logger.set_level(LOG_LVL_NONE)
        Logger("X").warning("hidden")
        assert "hidden" not in capsys.readouterr().out
        Logger.set_level(LOG_LVL_WARNING)

    def test_log_at_none_raises(self):
        with pytest.raises(ValueError):
            Logger("X").log("m", LOG_LVL_NONE)

    def test_file_sink(self, tmp_path):
        f = str(tmp_path / "log.txt")
        Logger.set_level(LOG_LVL_INFO)
        Logger.set_file(f)
        Logger("Y").info("to-file")
        Logger.set_file(None)
        Logger.set_level(LOG_LVL_WARNING)
        assert "to-file" in open(f).read()

    def test_root_from_class(self, capsys):
        Logger.set_level(LOG_LVL_INFO)

        class Thing:
            pass

        Logger(Thing()).info("msg")
        assert "[Thing]" in capsys.readouterr().out
        Logger.set_level(LOG_LVL_WARNING)


class TestConfig:
    def test_defaults(self):
        cfg = get_config()
        assert cfg.use_fastio is True
        assert np.dtype(cfg.id_dtype) == np.int32

    def test_set_and_restore(self):
        set_config(use_fastio=False)
        assert get_config().use_fastio is False
        set_config(use_fastio=True)
        assert get_config().use_fastio is True


class TestDtypeMachinery:
    def test_can_fit(self):
        assert can_dtype_fit(np.int8, np.array([1, 127]))
        assert not can_dtype_fit(np.int8, np.array([128]))
        assert can_dtype_fit(np.int32, np.array([1.0, 2.0]))
        assert not can_dtype_fit(np.int32, np.array([1.5]))
        assert can_dtype_fit(np.float32, np.array([1 << 20], np.int64))
        assert not can_dtype_fit(np.float32, np.array([(1 << 24) + 1], np.int64))

    def test_convert_checked(self):
        out = convert_array_dtype(np.array([1, 2], np.int64), np.int8)
        assert out.dtype == np.int8
        with pytest.raises(TypeMismatchError):
            convert_array_dtype(np.array([300], np.int64), np.int8)

    def test_index_dtype(self):
        assert index_dtype_for(100) == np.int32 or str(index_dtype_for(100)).endswith("int32")
        big = index_dtype_for(2**40)
        assert "64" in str(np.dtype(big))


class TestExactRatio:
    @pytest.mark.parametrize("hi", [50, 5000, 1 << 24])
    def test_matches_correctly_rounded_quotient(self, hi):
        from sparsebase_tpu.utils.exact import ratio_f32

        rng = np.random.default_rng(hi)
        den = rng.integers(1, hi, 50_000).astype(np.int32)
        num = rng.integers(0, hi, 50_000).astype(np.int32)
        got = np.asarray(ratio_f32(num, den))
        want = (num.astype(np.float64) / den).astype(np.float32)
        np.testing.assert_array_equal(got, want)

    def test_edges(self):
        from sparsebase_tpu.utils.exact import ratio_f32

        top = (1 << 24) - 1
        num = np.array([0, 1, 1, 2, 3, 7, top, 1, 5, top], np.int32)
        den = np.array([1, 1, 3, 3, 1, top, 1, top, 2, top - 1], np.int32)
        want = (num.astype(np.float64) / den).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(ratio_f32(num, den)), want)
