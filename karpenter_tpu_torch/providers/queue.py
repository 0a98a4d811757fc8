"""Interruption-queue provider — the SQS provider analogue.

Mirrors pkg/providers/sqs/sqs.go:28-99: long-poll receive (20-message max),
delete after handling, send for tests. The queue carries cloud interruption
events (spot reclaim, rebalance recommendation, scheduled change, instance
state change — pkg/controllers/interruption/messages/*).
"""

from __future__ import annotations

from typing import List

MAX_MESSAGES = 20  # sqs.go:53-73 long-poll batch size


class QueueProvider:
    def __init__(self, cloud):
        self.cloud = cloud

    def receive(self) -> List[dict]:
        return self.cloud.receive_messages(max_messages=MAX_MESSAGES)

    def delete(self, msg: dict) -> None:
        self.cloud.delete_message(msg)

    def send(self, msg: dict) -> None:
        self.cloud.interruption_queue.append(msg)
