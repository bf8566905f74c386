"""Serving's error types. Mirrors ``variational_mmt_tpu/serve/errors.py``.

``ClientError`` marks a request the client got wrong (an over-length or
empty source, misshaped image features, a malformed payload); the HTTP
layer maps it to 400. Everything else stays a 500, so a server bug is never
reported as the client's malformed input. It subclasses ``ValueError`` so
callers catching ``ValueError`` keep working. This module imports no torch:
dispatcher processes import it through the frontend.
"""


class ClientError(ValueError):
    pass
