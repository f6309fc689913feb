from repro_torch.serve.engine import Engine, Request, ServeResult  # noqa: F401
