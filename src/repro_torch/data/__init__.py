from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       make_batch_iterator)

__all__ = ["DataConfig", "SyntheticLMStream", "make_batch_iterator"]
