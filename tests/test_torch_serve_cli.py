"""The port's serving CLI (``repro_torch.launch.serve``) on the CPU at the
smoke size, for each of the ten architectures: its ``req`` lines are the
port's ``greedy_generate`` on ``init_params(cfg, 0)`` with the CLI's
seeded prompts (``serve.prompts``), and musicgen-medium, which takes frame
embeddings, raises where the reference's CLI does. The greedy parity
tests (``test_torch_lm_serve.py``, ``test_torch_lm_families.py``,
``test_torch_lm_recurrent.py``) hold those tokens against the JAX package.

Tolerance: exact (the same tokens).
"""
import io
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402

BATCH, PROMPT, NEW = 2, 4, 3
ARGS = ["--smoke", "--device", "cpu", "--batch", str(BATCH), "--prompt-len",
        str(PROMPT), "--max-new", str(NEW)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_is_greedy_generate(arch):
    cfg = get_config(arch, smoke=True)
    if cfg.frontend == "audio_frames":
        with pytest.raises(ValueError, match="frame_embeds"):
            serve_cli.main(["--arch", arch, *ARGS])
        return
    out = io.StringIO()
    with redirect_stdout(out):
        serve_cli.main(["--arch", arch, *ARGS])
    want = greedy_generate(cfg, init_params(cfg, 0, device="cpu"),
                           serve_cli.prompts(cfg, BATCH, PROMPT),
                           max_new_tokens=NEW, device="cpu")
    assert want.shape == (BATCH, NEW)
    assert out.getvalue().splitlines() == [
        f"req{i}: {want[i].numpy()}" for i in range(BATCH)]


def test_reference_serve_cli_raises_for_audio(monkeypatch):
    """The reference's CLI feeds tokens to musicgen-medium, which takes
    frame embeddings: ``KeyError``, where the port's raises ``ValueError``
    before any work."""
    from repro.launch import serve as ref_cli
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "musicgen-medium",
                                      *ARGS[:1], *ARGS[3:]])
    with pytest.raises(KeyError, match="frame_embeds"):
        ref_cli.main()
