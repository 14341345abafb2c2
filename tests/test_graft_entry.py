"""Driver-contract guard: entry() compiles and dryrun_multichip() runs."""

import sys
import pathlib

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    prod, parity = jax.jit(fn)(*args)
    assert prod.shape == (40, 128 * 128)
    assert int(parity) in (0, 1)


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_2():
    import __graft_entry__ as g

    g.dryrun_multichip(2)


def test_ensure_devices_raises_when_too_few():
    """No silent platform switch: asking for more devices than exist raises."""
    import pytest

    import __graft_entry__ as g

    have = len(jax.devices())
    g._ensure_devices(have)
    with pytest.raises(RuntimeError, match=f"need {have * 2} devices, have {have}"):
        g._ensure_devices(have * 2)
