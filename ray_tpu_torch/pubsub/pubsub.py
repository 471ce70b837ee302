"""Long-poll channelized pubsub.

Reference semantics (src/ray/pubsub/publisher.cc):
- A subscriber registers (subscriber_id, channel, optional key); key=None
  subscribes to every key on the channel (the reference's
  SubscribeToAllKeys path, publisher.h:138).
- The publisher appends matching messages to a per-subscriber bounded
  mailbox; `poll` long-polls until messages exist or the timeout lapses
  (the gRPC long-poll of PubsubLongPolling).
- Mailboxes are bounded: the oldest messages drop first and the drop
  count is reported in-band, like the reference's
  publisher_entity_buffer_max_bytes eviction.
- Subscribers that stop polling are garbage-collected after
  `subscriber_timeout_s` (reference: Publisher::CheckDeadSubscribers).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

ACTOR_CHANNEL = "ACTOR"
NODE_CHANNEL = "NODE"
OBJECT_LOCATION_CHANNEL = "OBJECT_LOCATION"
LOG_CHANNEL = "LOG"
ERROR_CHANNEL = "ERROR"
JOB_CHANNEL = "JOB"


class _Mailbox:
    __slots__ = ("queue", "event", "dropped", "last_poll", "delivered")

    def __init__(self, maxlen: int):
        self.queue: deque = deque(maxlen=maxlen)
        self.event = threading.Event()
        self.dropped = 0
        self.last_poll = time.monotonic()
        # cumulative count of messages ever popped to this subscriber:
        # the poll reply carries it as `seq` so the subscriber can
        # detect batches lost in transit (pop is destructive; a reply
        # that dies on a dropped connection takes its messages with it)
        self.delivered = 0


class Publisher:
    def __init__(self, mailbox_maxlen: int = 10_000,
                 subscriber_timeout_s: float = 300.0):
        self._lock = threading.Lock()
        self._mailbox_maxlen = mailbox_maxlen
        self._subscriber_timeout_s = subscriber_timeout_s
        # (channel, key) -> set of subscriber ids; key None = all keys
        self._subs: Dict[Tuple[str, Optional[str]], set] = {}
        self._mailboxes: Dict[str, _Mailbox] = {}
        self.num_published = 0

    # ------------------------------------------------------------ subscribe
    def subscribe(self, subscriber_id: str, channel: str,
                  key: Optional[str] = None) -> dict:
        with self._lock:
            self._subs.setdefault((channel, key), set()).add(subscriber_id)
            if subscriber_id not in self._mailboxes:
                self._mailboxes[subscriber_id] = _Mailbox(
                    self._mailbox_maxlen)
        return {"ok": True}

    def unsubscribe(self, subscriber_id: str,
                    channel: Optional[str] = None,
                    key: Optional[str] = None) -> dict:
        with self._lock:
            if channel is None:  # drop the subscriber entirely
                for subs in self._subs.values():
                    subs.discard(subscriber_id)
                self._subs = {k: v for k, v in self._subs.items() if v}
                box = self._mailboxes.pop(subscriber_id, None)
                if box is not None:
                    box.event.set()  # release a parked poll
            else:
                subs = self._subs.get((channel, key))
                if subs is not None:
                    subs.discard(subscriber_id)
                    if not subs:
                        self._subs.pop((channel, key), None)
        return {"ok": True}

    # -------------------------------------------------------------- publish
    def publish(self, channel: str, key: str, message: Any) -> int:
        """Returns the number of subscriber mailboxes reached."""
        with self._lock:
            targets = set()
            for sub_key in ((channel, key), (channel, None)):
                targets |= self._subs.get(sub_key, set())
            self.num_published += 1
            reached = 0
            for sid in targets:
                box = self._mailboxes.get(sid)
                if box is None:
                    continue
                if len(box.queue) == box.queue.maxlen:
                    box.dropped += 1
                box.queue.append((channel, key, message))
                box.event.set()
                reached += 1
        return reached

    # ----------------------------------------------------------------- poll
    def poll(self, subscriber_id: str, timeout: float = 30.0,
             max_messages: int = 1000) -> dict:
        """Long-poll: blocks until messages exist or timeout lapses.
        Returns {messages: [(channel, key, message)...], dropped: int}."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            with self._lock:
                box = self._mailboxes.get(subscriber_id)
                if box is None:
                    return {"messages": [], "dropped": 0,
                            "unsubscribed": True}
                box.last_poll = time.monotonic()
                if box.queue:
                    out = []
                    while box.queue and len(out) < max_messages:
                        out.append(box.queue.popleft())
                    dropped, box.dropped = box.dropped, 0
                    seq = box.delivered
                    box.delivered += len(out)
                    if not box.queue:
                        box.event.clear()
                    return {"messages": out, "dropped": dropped,
                            "seq": seq}
                box.event.clear()
                event = box.event
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"messages": [], "dropped": 0}
            event.wait(remaining)

    # ------------------------------------------------------------------- gc
    def gc_dead_subscribers(self) -> List[str]:
        """Drop subscribers that have not polled within the timeout
        (reference: Publisher::CheckDeadSubscribers)."""
        now = time.monotonic()
        dead = []
        with self._lock:
            for sid, box in list(self._mailboxes.items()):
                if now - box.last_poll > self._subscriber_timeout_s:
                    dead.append(sid)
        for sid in dead:
            self.unsubscribe(sid)
        return dead

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_subscribers": len(self._mailboxes),
                "num_subscriptions": sum(
                    len(v) for v in self._subs.values()),
                "num_published": self.num_published,
            }


class Subscriber:
    """Drives long-polling against a Publisher through pluggable
    transport callables, dispatching to registered callbacks on a
    dedicated thread (reference: subscriber.cc SubscriberChannel).

    In-process:   Subscriber("sid", publisher=pub)
    Over RPC:     Subscriber("sid",
                      poll_fn=lambda **kw: client.call("pubsub_poll", **kw),
                      subscribe_fn=..., unsubscribe_fn=...)
    """

    def __init__(self, subscriber_id: str,
                 publisher: Optional[Publisher] = None,
                 poll_fn: Optional[Callable[..., dict]] = None,
                 subscribe_fn: Optional[Callable[..., dict]] = None,
                 unsubscribe_fn: Optional[Callable[..., dict]] = None,
                 poll_timeout_s: float = 5.0):
        if publisher is not None:
            poll_fn = publisher.poll
            subscribe_fn = publisher.subscribe
            unsubscribe_fn = publisher.unsubscribe
        if poll_fn is None or subscribe_fn is None:
            raise ValueError("need a publisher or transport callables")
        self.subscriber_id = subscriber_id
        self._poll_fn = poll_fn
        self._subscribe_fn = subscribe_fn
        self._unsubscribe_fn = unsubscribe_fn
        self._poll_timeout_s = poll_timeout_s
        self._lock = threading.Lock()
        # (channel, key) -> [callback]; key None = all-keys callbacks
        self._callbacks: Dict[Tuple[str, Optional[str]], List[Callable]] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._pending_resub: set = set()  # keys to re-register with server
        self.num_dropped = 0
        # messages confirmed lost in transit (a poll reply popped them
        # server-side but never arrived — e.g. a reconnecting transport
        # retried after the connection died mid-reply); detected via the
        # server-side `seq` counter in poll replies
        self.num_lost = 0
        self._next_seq: Optional[int] = None

    def subscribe(self, channel: str, key: Optional[str],
                  callback: Callable[[str, str, Any], None]) -> None:
        with self._lock:
            self._callbacks.setdefault((channel, key), []).append(callback)
        self._subscribe_fn(subscriber_id=self.subscriber_id,
                           channel=channel, key=key)
        self._ensure_thread()

    def unsubscribe(self, channel: str, key: Optional[str] = None) -> None:
        with self._lock:
            self._callbacks.pop((channel, key), None)
            self._pending_resub.discard((channel, key))
        if self._unsubscribe_fn is not None:
            self._unsubscribe_fn(subscriber_id=self.subscriber_id,
                                 channel=channel, key=key)

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._poll_loop, daemon=True,
                    name=f"pubsub-sub-{self.subscriber_id[:8]}")
                self._thread.start()

    def _flush_pending_resubs(self) -> None:
        """Re-register subscriptions the server lost; keys whose RPC
        fails stay pending and retry on the next loop iteration — a
        partial failure must not leave one channel silently deaf."""
        with self._lock:
            pending = list(self._pending_resub)
        for channel, key in pending:
            try:
                self._subscribe_fn(subscriber_id=self.subscriber_id,
                                   channel=channel, key=key)
            except Exception:
                continue  # still pending; retried next iteration
            with self._lock:
                self._pending_resub.discard((channel, key))

    def _poll_loop(self) -> None:
        while not self._closed:
            self._flush_pending_resubs()
            try:
                reply = self._poll_fn(subscriber_id=self.subscriber_id,
                                      timeout=self._poll_timeout_s)
            except Exception:
                if self._closed:
                    return
                time.sleep(0.2)  # transport hiccup: retry
                continue
            if reply.get("unsubscribed"):
                # The publisher dropped us (idle GC, publisher restart):
                # queue every live subscription for re-registration and
                # keep polling — going silently deaf would lose events
                # with no error (reference: subscriber re-subscribes on
                # publisher failover).
                with self._lock:
                    keys = list(self._callbacks.keys())
                    if not keys or self._closed:
                        self._thread = None
                        return
                    self._pending_resub.update(keys)
                continue
            self.num_dropped += reply.get("dropped", 0)
            seq = reply.get("seq")
            if seq is not None:
                if self._next_seq is not None and seq > self._next_seq:
                    lost = seq - self._next_seq
                    self.num_lost += lost
                    import logging

                    logging.getLogger(__name__).warning(
                        "pubsub subscriber %s lost %d message(s) in "
                        "transit (server seq %d, expected %d)",
                        self.subscriber_id, lost, seq, self._next_seq)
                elif self._next_seq is not None and seq < self._next_seq:
                    # publisher restarted / mailbox recreated after idle
                    # GC: its counter reset — resynchronize, don't count
                    pass
                self._next_seq = seq + len(reply.get("messages", ()))
            for channel, key, message in reply.get("messages", ()):
                with self._lock:
                    cbs = list(self._callbacks.get((channel, key), ())) + \
                        list(self._callbacks.get((channel, None), ()))
                for cb in cbs:
                    try:
                        cb(channel, key, message)
                    except Exception:  # a callback must not kill the loop
                        import logging

                        logging.getLogger(__name__).exception(
                            "pubsub callback failed")

    def close(self) -> None:
        self._closed = True
        if self._unsubscribe_fn is not None:
            try:
                self._unsubscribe_fn(subscriber_id=self.subscriber_id)
            except Exception:
                pass
