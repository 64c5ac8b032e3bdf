"""Serving: the forecast service (``server``) and the exported artifact
(``export``). The service's names load on first use, so that loading an
artifact (``export.load_forecaster``) pulls in no model code."""

__all__ = ["ForecastService", "make_server", "serve"]


def __getattr__(name: str):
    if name in __all__:
        from tec_mollm_tpu_torch.serving import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
