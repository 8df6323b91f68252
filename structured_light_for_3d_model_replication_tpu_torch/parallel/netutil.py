"""Endpoint parsing shared by every fabric dial/bind site.

The coordinator server, the worker's ``CoordClient``, and the blobstore
client/server all take their addresses from config strings; this module is
the ONE place those strings are interpreted, so a worker never dials an
address the coordinator didn't bind. The JAX package's copy
(``parallel/netutil.py``) reads the same strings the same way.

Accepted forms (all return ``(host, port)``):

  - ``"host:port"``        — ``"10.0.0.7:9100"``
  - ``"[v6]:port"``        — ``"[::1]:9100"`` (brackets required for IPv6
    literals, like a URL authority — a bare ``::1:9100`` is ambiguous)
  - ``":port"`` / ``"port"`` — host defaults to ``default_host``
  - ``"host:"`` / ``"host"`` — port defaults to ``default_port``

``format_endpoint`` is the inverse: it re-brackets IPv6 literals so a
round-trip through config strings (e.g. the coordinator advertising its
blobstore endpoint in the ``hello`` reply) always re-parses.
"""
from __future__ import annotations

__all__ = ["parse_endpoint", "format_endpoint", "worker_tag",
           "parse_worker_tag"]


def parse_endpoint(text: str, default_host: str = "127.0.0.1",
                   default_port: int = 0) -> tuple[str, int]:
    """Parse ``text`` into ``(host, port)``; see module docstring for the
    accepted forms. Raises ``ValueError`` with the offending text on
    anything else — a fabric dial site must never guess."""
    s = (text or "").strip()
    if not s:
        return default_host, default_port
    if s.startswith("["):                      # [v6]:port or [v6]
        close = s.find("]")
        if close < 0:
            raise ValueError(f"unclosed '[' in endpoint {text!r}")
        host = s[1:close]
        rest = s[close + 1:]
        if rest == "":
            return host or default_host, default_port
        if not rest.startswith(":"):
            raise ValueError(f"garbage after ']' in endpoint {text!r}")
        return host or default_host, _port(rest[1:], text)
    if s.count(":") > 1:                       # unbracketed IPv6 literal
        raise ValueError(
            f"IPv6 literal in endpoint {text!r} must be bracketed, "
            f"e.g. '[::1]:9100'")
    if ":" in s:
        host, _, port = s.partition(":")
        return (host or default_host,
                _port(port, text) if port else default_port)
    if s.isdigit():                            # bare port
        return default_host, _port(s, text)
    return s, default_port                     # bare host


def format_endpoint(host: str, port: int) -> str:
    """``(host, port)`` back to a parseable string; IPv6 literals get
    their brackets back."""
    if ":" in host and not host.startswith("["):
        return f"[{host}]:{port}"
    return f"{host}:{port}"


def worker_tag(worker: str, generation: int = 0) -> str:
    """Display identity of one worker INCARNATION: ``fw0`` for the first
    spawn, ``fw0#g2`` for its second respawn. The fleet supervisor reuses
    the RANK (the lease/ledger identity stays ``fw0`` — steals and grants
    fence on generations already) while the generation stamp lets
    ``report`` tell a healed worker from a flapping one."""
    g = int(generation)
    return f"{worker}#g{g}" if g > 0 else str(worker)


def parse_worker_tag(tag: str) -> tuple[str, int]:
    """Inverse of :func:`worker_tag`: ``(worker, generation)``. A tag
    without a ``#g`` suffix (pre-fleet workers, rank-0 incarnations) is
    generation 0; a malformed suffix stays part of the name rather than
    guessing."""
    s = str(tag or "")
    base, sep, rest = s.rpartition("#g")
    if sep and rest.isdigit():
        return base, int(rest)
    return s, 0


def _port(s: str, original: str) -> int:
    try:
        p = int(s)
    except ValueError:
        raise ValueError(f"non-numeric port in endpoint {original!r}") \
            from None
    if not 0 <= p <= 65535:
        raise ValueError(f"port out of range in endpoint {original!r}")
    return p
