from repro_torch.data.synthetic import (audio_stream, latent_stream,  # noqa: F401
                                        token_stream, video_latents)
