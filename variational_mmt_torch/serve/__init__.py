"""Online serving over the port's ``Translator``. Mirrors
``variational_mmt_tpu/serve/``: ``TranslationService`` (a queue and a
worker thread that batches requests dynamically into the offline path's
device shapes), ``ServingServer`` (a threaded HTTP server in the service's
process) and ``MPServingServer`` (HTTP dispatcher processes sharing one
port, forwarding over a unix-socket RPC).

The exports are lazy (PEP 562): dispatcher processes import
``serve.frontend``, which must not pull in torch or the model stack
through this package's ``__init__``.
"""

_EXPORTS = {
    "ClientError": "variational_mmt_torch.serve.errors",
    "MPServingServer": "variational_mmt_torch.serve.http_server",
    "ServingServer": "variational_mmt_torch.serve.http_server",
    "ServeConfig": "variational_mmt_torch.serve.service",
    "TranslationService": "variational_mmt_torch.serve.service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
