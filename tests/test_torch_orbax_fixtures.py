"""The committed orbax fixtures (``predict_pv_yield_tpu_torch/testdata/
orbax/``) written again by the JAX ``Trainer`` in a temporary directory:
the same leaves with the same values (``expected.json``; the files' bytes
may differ run to run), and the port's reader bit-equal to orbax's restore
on the fresh copy."""

import pytest

from tests.test_torch_orbax import (FIXTURES, _flat, _orbax_restore, leaf_hashes, write_conv3d_fixture,
                                    write_perceiver_fixture)


@pytest.mark.parametrize("fixture,writer", [("conv3d_sat_nwp", write_conv3d_fixture),
                                            ("perceiver_tp", write_perceiver_fixture)])
def test_fixture_written_again_has_the_committed_values(fixture, writer, tmp_path, monkeypatch):
    import json

    from predict_pv_yield_tpu_torch.training.orbax import read_train_state

    monkeypatch.chdir(tmp_path)
    checkpoint = writer(str(tmp_path))
    expected = json.load(open(FIXTURES / fixture / "expected.json"))
    assert leaf_hashes(_orbax_restore(checkpoint)) == expected
    assert leaf_hashes(dict(_flat(read_train_state(checkpoint)))) == expected
    with open(FIXTURES / fixture / "last" / "loop.json") as fh, open(f"{checkpoint}/loop.json") as again:
        assert json.load(fh) == json.load(again)
