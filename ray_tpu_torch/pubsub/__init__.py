"""Channelized pubsub (reference: src/ray/pubsub/publisher.{h,cc},
subscriber.{h,cc} — long-poll based channels; pubsub/README.md).

`Publisher` holds per-subscriber bounded mailboxes; `Subscriber` drives a
long-poll loop over any transport (direct method calls in-process, the
framed-TCP RPC substrate across processes) and dispatches to per-channel
callbacks. Channels mirror the reference's channel types
(src/ray/protobuf/pubsub.proto ChannelType).
"""

from ray_tpu_torch.pubsub.pubsub import (
    ACTOR_CHANNEL,
    ERROR_CHANNEL,
    JOB_CHANNEL,
    LOG_CHANNEL,
    NODE_CHANNEL,
    OBJECT_LOCATION_CHANNEL,
    Publisher,
    Subscriber,
)

__all__ = [
    "Publisher",
    "Subscriber",
    "ACTOR_CHANNEL",
    "ERROR_CHANNEL",
    "JOB_CHANNEL",
    "LOG_CHANNEL",
    "NODE_CHANNEL",
    "OBJECT_LOCATION_CHANNEL",
]
