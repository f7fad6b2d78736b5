from repro_torch.serve.engine import GenerationConfig, ServeEngine

__all__ = ["ServeEngine", "GenerationConfig"]
