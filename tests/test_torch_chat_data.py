"""The chat data families on the port's GLOBAL channel: an update of the
port's own chat family (``models/chat.proto``, ``chtpu.chat``) into a
channel that speaks the reference-compatible one (``compat/chatpb.proto``,
``chatpb``, as ``-imports channeld_tpu_torch.compat`` registers it), and
``chip_smoke.py``'s phase 8c, which replays examples/sessions/chat_demo.cpr
(recorded with ``chtpu.chat`` payloads) against such a gateway.

ROADMAP F20, a fault of the reference fixed in the port: the chat merge
takes the other family's update (same fields), but the reference buffers
the update as it came, and the first fan-out window that starts with it
fails in ``MergeFrom``: the GLOBAL channel's tick task dies, every later
message to GLOBAL (a client's AUTH among them) goes unanswered, and 8c's
replay sees a connection left unauthenticated when one AUTH comes late.
"""

from __future__ import annotations

import importlib

import pytest

from test_torch_elastic import chip_smoke
from test_torch_gateway import JAX, PORT, fresh_runtime


def chat_update(pkg: str, monkeypatch):
    """A GLOBAL ``ChannelData`` of the compat family holding the welcome
    message, with one ``chtpu.chat`` update from a client taken in;
    returns (data module, channel data)."""
    data_mod = importlib.import_module(f"{pkg}.core.data")
    chat = importlib.import_module(f"{pkg}.models.chat")
    chatpb = importlib.import_module(f"{pkg}.compat.chatpb_pb2")
    control_pb2 = importlib.import_module(f"{pkg}.protocol.control_pb2")
    # The pb2 classes are both packages' (one descriptor pool): hold this
    # package's merge on them for the test only.
    monkeypatch.setattr(chatpb.ChatChannelData, "merge", chat._chat_merge, raising=False)
    monkeypatch.setattr(chat.ChatChannelData, "merge", chat._chat_merge, raising=False)
    fresh_runtime(pkg)
    initial = chatpb.ChatChannelData()
    initial.chatMessages.add(sender="System", sendTime=1, content="Welcome!")
    data = data_mod.ChannelData(initial, control_pb2.ChannelDataMergeOptions(
        listSizeLimit=100, truncateTop=True))
    update = chat.ChatChannelData()
    update.chatMessages.add(sender="client", sendTime=2, content="hello")
    data.on_update(update, 10, 7, None)
    return data_mod, data


def test_reference_buffers_the_other_familys_update_and_its_window_fails(monkeypatch):
    """The JAX package as it is: the merge takes the update, the ring keeps
    it as it came, and accumulating a window that starts with it raises."""
    data_mod, data = chat_update(JAX, monkeypatch)
    assert [m.content for m in data.msg.chatMessages] == ["Welcome!", "hello"]
    assert type(data.update_msg_buffer[-1].update_msg) is not type(data.msg)
    with pytest.raises(TypeError, match="MergeFrom"):
        data_mod._accumulate_window(data, data.update_msg_buffer[-1:])


def test_port_buffers_the_update_as_the_channels_own_type(monkeypatch):
    """The port: the ring holds the update as the channel's own type, with
    its content, and its window accumulates."""
    data_mod, data = chat_update(PORT, monkeypatch)
    assert [m.content for m in data.msg.chatMessages] == ["Welcome!", "hello"]
    buffered = data.update_msg_buffer[-1].update_msg
    assert type(buffered) is type(data.msg)
    assert [m.content for m in buffered.chatMessages] == ["hello"]
    acc = data_mod._accumulate_window(data, data.update_msg_buffer[-1:], fresh=True)
    assert [m.content for m in acc.chatMessages] == ["hello"]


def test_chat_demo_replay_against_the_port_gateway_on_the_cpu():
    """Phase 8c on the CPU: ``python -m channeld_tpu_torch -imports
    channeld_tpu_torch.compat -spatial-device cpu`` as a child, the replay
    CLI's 8 connections all authenticated, every packet sent, no channel's
    tick task dead, SIGTERM exit 0."""
    chip_smoke().phase_replay_live(dev_args=("-spatial-device", "cpu"), deadline_s=60.0)
