"""Replica context for engines hosted by a serve replica.

The port has no replica host yet, so there is never a context: engines
tag themselves as standalone.
"""

from __future__ import annotations


def get_replica_context():
    return None
