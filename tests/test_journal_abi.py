"""Golden-bytes regression of the journal on-disk format.

The reference hardcodes expected on-disk images to guard its storage
ABI (t_index_terms.c:23-39, t_index_dtmap.c:25-42).  Our journal
format is new (little-endian, commit-pointer header; see
index/storage.py) but needs the same guard: existing indexes must
stay readable across releases.
"""

import struct

import pytest

from nxsearch_tpu.index import storage
from nxsearch_tpu.index.hostindex import HostIndex
from nxsearch_tpu.text.tokenizer import TOKENSET_STAGE, Token, TokenSet


def make_tokens(values_counts):
    ts = TokenSet()
    for value, count in values_counts:
        token = Token(value=value, count=count)
        ts.tokens.append(token)
        ts._map[value] = token
        ts.seen += count
    return ts


def test_terms_journal_golden_bytes(tmp_path):
    h = HostIndex(str(tmp_path))
    ts = make_tokens([("cat", 1), ("dogs", 2)])
    ts.resolve(h.term_lookup, TOKENSET_STAGE)
    h.terms_add(ts)
    h.close()

    raw = (tmp_path / "terms.db").read_bytes()
    expected_header = struct.pack("<IIQ16x", 0x5454584E, 1, 16)
    expected_payload = (
        b"\x03\x00\x00\x00" b"cat\x00"       # len=3, "cat", pad4
        b"\x04\x00\x00\x00" b"dogs"          # len=4, "dogs" (no pad)
    )
    assert raw == expected_header + expected_payload


def test_dtmap_journal_golden_bytes(tmp_path):
    h = HostIndex(str(tmp_path))
    ts = make_tokens([("cat", 2), ("dogs", 1)])
    ts.resolve(h.term_lookup, TOKENSET_STAGE)
    h.terms_add(ts)
    h.dtmap_add(7, ts)
    h.close()

    raw = (tmp_path / "dtmap.db").read_bytes()
    expected_header = struct.pack("<IIQ16x", 0x4454584E, 1, 32)
    expected_payload = (
        struct.pack("<QII", 7, 3, 2)         # doc_id=7, doc_len=3, n=2
        + struct.pack("<II", 1, 2)           # (term 1 "cat", count 2)
        + struct.pack("<II", 2, 1)           # (term 2 "dogs", count 1)
    )
    assert raw == expected_header + expected_payload


@pytest.mark.parametrize("pread_max", [3, 8, 1 << 20])
def test_replay_reads_journal_in_pieces(tmp_path, monkeypatch, pread_max):
    """A journal tail longer than one pread(2) replays whole: the
    reader loops over pieces of at most PREAD_MAX bytes (here shrunk so
    that a small journal takes many, some of them cut mid-record)."""
    h = HostIndex(str(tmp_path))
    for doc_id in range(1, 6):
        ts = make_tokens([("cat", doc_id), (f"w{doc_id}", 1)])
        ts.resolve(h.term_lookup, TOKENSET_STAGE)
        h.terms_add(ts)
        h.dtmap_add(doc_id, ts)
    h.dtmap_remove(2)
    h.close()

    monkeypatch.setattr(storage, "PREAD_MAX", pread_max)
    r = HostIndex(str(tmp_path))
    assert r.term_values == ["cat", "w1", "w2", "w3", "w4", "w5"]
    assert r.doc_count == 4
    assert sorted(r.doc_map) == [1, 3, 4, 5]
    assert int(r.term_total.a[0]) == 1 + 3 + 4 + 5
    r.close()


def test_remove_tombstone_golden_bytes(tmp_path):
    h = HostIndex(str(tmp_path))
    ts = make_tokens([("cat", 1)])
    ts.resolve(h.term_lookup, TOKENSET_STAGE)
    h.terms_add(ts)
    h.dtmap_add(5, ts)
    h.dtmap_remove(5)
    h.close()

    raw = (tmp_path / "dtmap.db").read_bytes()
    # Original block's doc_id zeroed in place + appended {5, 0} marker.
    block = struct.pack("<QII", 0, 1, 1) + struct.pack("<II", 1, 1)
    marker = struct.pack("<QQ", 5, 0)
    expected_header = struct.pack("<IIQ16x", 0x4454584E, 1,
                                  len(block) + len(marker))
    assert raw == expected_header + block + marker
