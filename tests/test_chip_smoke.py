"""chip_smoke.py refuses to report a result without a GPU."""

import pytest


def test_main_refuses_a_cpu_device(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "preflight", lambda args: "no card")
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out
