"""Resident search server tests: server responses, and byte
equality of server-routed search/prefilter with the direct commands
(same code path, preloaded state).
"""

import json
import os
import pathlib
import threading
import time

import pytest

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    td = tmp_path_factory.mktemp("server")
    from metaeuk_tpu.cli import main
    from metaeuk_tpu.server import SearchServer, client_request
    assert main(["createdb", str(DATA / "proteins.faa"),
                 str(td / "tdb")]) == 0
    assert main(["createdb", str(DATA / "queries_lin.faa"),
                 str(td / "qdb")]) == 0
    sock = str(td / "srv.sock")
    server = SearchServer(str(td / "tdb"), sock, warmup=False)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    for _ in range(100):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    yield td, sock
    try:
        client_request(sock, {"op": "shutdown"}, timeout=10)
    except Exception:
        pass
    t.join(timeout=10)


def test_ping(served):
    from metaeuk_tpu.server import client_request
    td, sock = served
    resp = client_request(sock, {"op": "ping"})
    assert resp["ok"] and resp["target_db"].endswith("tdb")


def test_server_search_matches_direct(served):
    from metaeuk_tpu.search.searchdb import search_db
    from metaeuk_tpu.server import client_request
    td, sock = served
    resp = client_request(sock, {
        "op": "search", "query_db": str(td / "qdb"),
        "out_db": str(td / "srv_aln"), "tmp": str(td / "srv_tmp"),
        "evalue": 1e-3, "add_backtrace": True})
    assert resp["ok"], resp
    search_db(str(td / "qdb"), str(td / "tdb"), str(td / "dir_aln"),
              str(td / "dir_tmp"), evalue=1e-3, add_backtrace=True)
    for s in ("", ".index", ".dbtype"):
        assert (td / f"srv_aln{s}").read_bytes() == \
            (td / f"dir_aln{s}").read_bytes(), s


def test_server_prefilter_matches_direct(served):
    from metaeuk_tpu.search.searchdb import prefilter_db
    from metaeuk_tpu.server import client_request
    td, sock = served
    resp = client_request(sock, {
        "op": "prefilter", "query_db": str(td / "qdb"),
        "out_db": str(td / "srv_pref")})
    assert resp["ok"], resp
    prefilter_db(str(td / "qdb"), str(td / "tdb"), str(td / "dir_pref"))
    for s in ("", ".index", ".dbtype"):
        assert (td / f"srv_pref{s}").read_bytes() == \
            (td / f"dir_pref{s}").read_bytes(), s


def test_unknown_op(served):
    from metaeuk_tpu.server import client_request
    td, sock = served
    resp = client_request(sock, {"op": "nope"})
    assert not resp["ok"]
