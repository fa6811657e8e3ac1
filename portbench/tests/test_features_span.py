"""The reader of the program's span ``rooms.features`` (the room's
conditioning copied to the card once a room) on made-up traces, against
values computed by hand, as ``test_program_spans.py`` holds the other
room readers."""

from __future__ import annotations

import pytest

from test_program_spans import objects, read, room, trace

NAME = "features_ms.room"


def features_room(units: int = 1):
    """``units`` rooms in one window: in each 2000 us, ``rooms.batches``
    opens with ``rooms.features`` 0-300 and holds ``rooms.upload``
    300-350."""
    spans = []
    for r in range(units):
        t = 2000 * r
        spans += [("rooms.batches", t, t + 1500), ("rooms.features", t, t + 300),
                  ("rooms.upload", t + 300, t + 350)]
    return trace(spans, [], 2000 * units, units)


@pytest.mark.parametrize("units", [1, 3])
def test_features_ms_is_the_copy_a_room(units):
    assert read(NAME, features_room(units)) == pytest.approx(0.3)


def test_nothing_to_read_without_the_span():
    # a parent's room (its batches and uploads, no features span), an object
    # call, a room of no unit
    assert read(NAME, room()) is None
    assert read(NAME, objects()) is None
    t = features_room()
    t.units = 0
    assert read(NAME, t) is None
