"""The port's synthetic streams against the reference's
(``data/synthetic.py``): the same seed draws the same numbers, so integers
and noise are bitwise equal; ``latents`` (x_t of the DDPM forward, each
package's own noise schedule on its own device) within rtol 1e-6, atol
1e-6 of latents of order 1."""
import tests.torch_threads  # noqa: F401  (first: one thread)
import numpy as np
import pytest

from repro.data import audio_stream as jaudio_stream
from repro.data import latent_stream as jlatent_stream
from repro.data import token_stream as jtoken_stream
from repro.data import video_latents as jvideo_latents
from repro_torch.data import (audio_stream, latent_stream, token_stream,
                              video_latents)

BATCHES = 3


def _take(it, n=BATCHES):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("vocab,batch,seq,seed", [(50, 3, 7, 5),
                                                  (1000, 2, 16, 0)])
def test_token_stream_matches_reference(vocab, batch, seq, seed):
    want = _take(jtoken_stream(vocab, batch, seq, seed=seed))
    got = _take(token_stream(vocab, batch, seq, seed=seed, device="cpu"))
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens"}
        assert g["tokens"].dtype.is_floating_point is False
        np.testing.assert_array_equal(g["tokens"].numpy(),
                                      np.asarray(w["tokens"]))


@pytest.mark.parametrize("batch,img,ch,classes,seed", [(4, 8, 4, 10, 1),
                                                       (2, 32, 4, 1000, 0)])
def test_latent_stream_matches_reference(batch, img, ch, classes, seed):
    want = _take(jlatent_stream(batch, img, ch, num_classes=classes,
                                seed=seed))
    got = _take(latent_stream(batch, img, ch, num_classes=classes,
                              seed=seed, device="cpu"))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("t", "labels", "noise"):
            assert str(g[k].dtype).endswith(str(np.asarray(w[k]).dtype)), k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)
        assert g["latents"].shape == tuple(w["latents"].shape)
        np.testing.assert_allclose(g["latents"].numpy(),
                                   np.asarray(w["latents"]), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("amp", [0.0, 1.0, 2.5])
def test_video_latents_match_reference(amp):
    want = np.asarray(jvideo_latents(2, 5, 16, 4, motion_amplitude=amp,
                                     seed=3))
    got = video_latents(2, 5, 16, 4, motion_amplitude=amp, seed=3,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_audio_stream_matches_reference():
    want = _take(jaudio_stream(2, 9, 12, 20, seed=4))
    got = _take(audio_stream(2, 9, 12, 20, seed=4, device="cpu"))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)


def test_streams_refuse_a_missing_card():
    """Entry points run on the card unless asked: without one, the default
    device raises instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        next(token_stream(10, 1, 2))
    with pytest.raises(RuntimeError):
        video_latents(1, 1, 4, 1)
