from repro_torch.data.synth import (make_classification,  # noqa: F401
                                    make_lm_tokens)
