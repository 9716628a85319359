"""S3 Select: streaming SQL over objects.

The JAX package's s3select over the port, line for line: the equivalent of
the reference's ``internal/s3select`` (select.go:218 ``S3Select``, sql/
parser+evaluator, csv/ and json/ readers). Hand-rolled recursive-descent SQL
parser (the reference uses participle), streaming record pipeline, AWS
event-stream response framing. Host code only: the object's bytes reach it
through the object layer's GET, whose bitrot verify and reconstruct run on
the card.
"""

from .select import S3SelectRequest, SelectError, run_select
from .eventstream import encode_message, decode_messages

__all__ = [
    "S3SelectRequest",
    "SelectError",
    "run_select",
    "encode_message",
    "decode_messages",
]
