"""Own copy of the header helper the serving handler uses from
``paddle_operator_tpu/utils/tracing.py``.  Span capture and trace
propagation come with the continuous-ring slice."""

from __future__ import annotations


def safe_header_value(value, cap: int = 128) -> str:
    """A client-supplied string (request_id) made safe to ECHO in a
    response header: printable ASCII only (CR/LF would split the
    response; non-latin-1 raises inside send_header AFTER the status
    line, truncating an otherwise-good reply), bounded length."""
    return "".join(c if " " <= c <= "~" else "_"
                   for c in str(value))[:cap]
