"""The serving twins (``examples/torch_serve_router.py``,
``examples/torch_control_serving.py``) against the JAX package's examples,
as ``test_torch_examples.py`` compares the others (its file header says
what is compared).  Their weights come from a ``torch.Generator``, so their
tokens are the port's own; each twin keeps the reference's own asserts
(identical outputs across policies, bit-identical tokens under control),
and the schedule numbers (local %, steals, prefill tokens, served, the
controller's snapshot, the replayed schedule) must equal the reference's.
"""
import pytest

from test_torch_examples import compare


@pytest.mark.parametrize("example", ["serve_router", "control_serving"])
def test_schedule_lines(example, capsys, monkeypatch):
    out, _, _ = compare(example, [], [], capsys, monkeypatch)
    assert "identical outputs under every policy" in out or \
        "decoded tokens bit-identical under control: OK" in out
