"""Differential tests of key translation and attributes: the port's
``TranslateStore`` and ``AttrStore``, and a keyed, attributed index
(the star-trace schema: users star repositories) answered by the port
and by the JAX package, exact equality throughout.

- stores: seeded random key sequences give identical ids one key at a
  time and in bulk; seeded attribute writes give identical attributes,
  deletes and ``ids_matching``;
- the index, filled in the JAX package through its API's keyed imports
  and carried over with ``load_state`` (ids as the JAX stores gave
  them), or filled through the same PQL on both packages: a script of
  reads and writes with keys and attributes through ``execute_full``,
  and the same script as one ``execute_batch_shaped`` with the
  megakernel on; answers, ids, keys and attributes equal;
- every key error message, keyed and unkeyed;
- keyed imports through both APIs, with mismatched ids and keys.
"""

import numpy as np
import pytest

from pilosa_tpu.core.attrs import AttrStore as JaxAttrStore
from pilosa_tpu.core.cache import RANK_CACHE as JAX_RANK_CACHE
from pilosa_tpu.core.holder import Holder as JaxHolder
from pilosa_tpu.core.translate import TranslateStore as JaxTranslateStore
from pilosa_tpu.server import API as JaxAPI
from pilosa_tpu.utils.stats import MemStatsClient
from pilosa_tpu_torch import Holder, load_state
from pilosa_tpu_torch.core.attrs import AttrStore
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.executor import megakernel as megamod
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.server.api import ApiError
from test_torch_executor import state_from_jax

N_REPOS = 300
N_USERS = 12
STARS = 40
LANGS = ["Python", "Go", "Rust", "C", "Haskell", "Zig"]
PARADIGM = {"Python": "scripting", "Go": "systems", "Rust": "systems",
            "C": "systems", "Haskell": "functional", "Zig": "systems"}


def repo_key(i):
    return f"org{i % 7}/repo{i}" + "abc"[:i % 4]


def star_data(seed=3):
    """(user keys, repo keys) of every star in draw order, each repo's
    language and star count."""
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(N_USERS), STARS)
    repos = rng.integers(0, N_REPOS, len(users))
    w = 1.0 / np.arange(1, len(LANGS) + 1)
    lang = rng.choice(len(LANGS), N_REPOS, p=w / w.sum())
    stars = rng.integers(0, 1001, N_REPOS)
    return ([f"user{u}" for u in users], [repo_key(int(r)) for r in repos],
            [LANGS[int(x)] for x in lang], stars)


def schema(api):
    api.create_index("repo", keys=True)
    api.create_field("repo", "stargazer", {"keys": True})
    api.create_field("repo", "language", {"keys": True})
    api.create_field("repo", "stars", {"type": "int", "min": 0,
                                       "max": 1000})
    api.create_field("repo", "plain")
    api.create_index("u")
    api.create_field("u", "f")


def load(api, seed=3):
    """The star-trace data through the API's keyed imports, then row
    and column attributes through PQL."""
    users, repos, lang, stars = star_data(seed)
    all_repos = [repo_key(i) for i in range(N_REPOS)]
    api.import_bits("repo", "stargazer", row_keys=users, column_keys=repos)
    api.import_bits("repo", "language", row_keys=lang,
                    column_keys=all_repos)
    api.import_values("repo", "stars", column_keys=all_repos,
                      values=stars)
    api.import_bits("repo", "plain", rows=[i % 3 for i in range(50)],
                    column_keys=all_repos[:50])
    api.import_bits("u", "f", rows=[1, 1, 2], columns=[3, 5, 5])
    q = " ".join(f"SetRowAttrs(stargazer, 'user{u}', "
                 f"active={str(u % 2 == 0).lower()}, followers={u * 10})"
                 for u in range(N_USERS))
    q += " " + " ".join(f"SetRowAttrs(language, '{x}', paradigm='{p}')"
                        for x, p in PARADIGM.items())
    q += " " + " ".join(
        f"SetColumnAttrs('{repo_key(i)}', url='https://x/{i}', "
        f"active={str(i % 3 == 0).lower()})" for i in range(0, N_REPOS, 10))
    api.executor.execute("repo", q)


def script():
    """Reads and writes with keys and attributes, in order."""
    r1, r2, r5 = repo_key(1), repo_key(2), repo_key(5)
    return [
        "Row(stargazer='user1')",
        "Count(Intersect(Row(stargazer='user1'), Row(stargazer='user2')))",
        "TopN(stargazer, n=5)",
        "TopN(language, Row(stargazer='user1'), n=3)",
        "TopN(stargazer, n=10, attrName='active', attrValues=[true])",
        "TopN(language, attrName='paradigm', "
        "attrValues=['functional', 'scripting'])",
        "Options(Row(stargazer='user3'), columnAttrs=true)",
        "Options(Row(language='Go'), excludeColumns=true)",
        "Options(Row(language='Go'), excludeRowAttrs=true)",
        "Sum(Row(language='Rust'), field=stars)",
        "Count(Row(stars > 500))",
        "Row(stars == 7)",
        "Min(field=stars) Max(Row(language='Python'), field=stars)",
        "Rows(language)",
        "Rows(stargazer, previous='user3', limit=4)",
        f"Rows(language, column='{r5}')",
        f"Rows(stargazer, column='{r1}')",
        "GroupBy(Rows(language), filter=Row(stargazer='user1'))",
        "GroupBy(Rows(language), Rows(plain), previous=['Go', 1], limit=3)",
        "Row(stargazer='nobody')",
        "Count(Row(stargazer='nobody2')) Row(language='Cobol')",
        "TopN(language, n=0)",
        "TopN(stargazer, ids=[1, 2, 3], n=2)",
        "Row(plain=1)",
        "Union(Row(stargazer='user1'), Row(plain=2))",
        "Not(Row(language='Go'))",
        "Difference(Row(stargazer='user1'), Row(stargazer='user2'))",
        "Set('neworg/newrepo', stargazer='user1')",
        "Row(stargazer='user1')",
        "SetRowAttrs(stargazer, 'user1', active=false)",
        "TopN(stargazer, n=10, attrName='active', attrValues=[true])",
        "SetRowAttrs(stargazer, 'user3', active=true, followers=null)",
        "TopN(stargazer, n=10, attrName='active', attrValues=[true])",
        "Row(stargazer='user3')",
        f"SetColumnAttrs('{r2}', url='https://y', active=null)",
        "SetColumnAttrs('brand/new', url='u')",
        "Options(Row(stargazer='user2'), columnAttrs=true)",
        f"Clear('{r2}', stargazer='user2')",
        "ClearRow(stargazer='user4')",
        "Row(stargazer='user4')",
        "Store(Row(language='Go'), stargazer='go-fans')",
        "Row(stargazer='go-fans')",
        "TopN(stargazer, n=5)",
        f"Set('{r5}', stars=999) Sum(field=stars)",
        "Set(1048600, plain=1)",
        "Row(plain=1)",
        "SetRowAttrs(language, 'Go', paradigm=null)",
        "Row(language='Go')",
        "Rows(stargazer, column='neworg/newrepo')",
        "Set('k2', language='Zig') Row(language='Zig')",
        "Clear('neworg/newrepo', stargazer='unknownuser')",
        "Rows(stargazer)",
        "GroupBy(Rows(stargazer), Rows(language), limit=6)",
    ]


def entries(idx):
    """Every store of an index (either package), with its attributes."""
    out = {"@cols": idx.column_translator.entries() if idx.keys else [],
           "@colattrs": dict(idx.column_attr_store.attrs)}
    for fname, f in idx.fields.items():
        out[fname] = (f.row_translator.entries() if f.options.keys else [],
                      dict(f.row_attr_store.attrs))
    return out


def jax_api(path):
    JAX_RANK_CACHE.clear()
    h = JaxHolder(str(path))
    h.open()
    return JaxAPI(h, stats=MemStatsClient())


def outcome(fn):
    try:
        return fn()
    except Exception as e:
        return ("error", str(e))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_translate_store_matches_jax(seed):
    """Ids in allocation order, one key at a time and in bulk, with
    create=False reads and reverse lookups."""
    rng = np.random.default_rng(seed)
    vocab = [f"k{i}" + "z" * (i % 5) for i in range(200)]
    jst, one, bulk = JaxTranslateStore(), TranslateStore(), TranslateStore()
    for _ in range(30):
        keys = [vocab[i] for i in rng.integers(0, len(vocab),
                                               int(rng.integers(0, 40)))]
        create = bool(rng.random() < 0.8)
        want = jst.translate_keys(keys, create=create)
        got_one = np.array([one.translate_key(k, create) or 0 for k in keys],
                           np.uint64)
        np.testing.assert_array_equal(got_one, want)
        np.testing.assert_array_equal(bulk.translate_keys(keys, create),
                                      want)
        assert bulk.translate_keys(keys, create).dtype == np.uint64
    assert one.entries() == bulk.entries() == jst.entries()
    assert one.size() == bulk.size() == jst.size()
    ids = list(range(0, jst.size() + 3))
    assert bulk.translate_ids(ids) == jst.translate_ids(ids)
    assert bulk.translate_ids(np.array(ids, np.uint64)) == \
        jst.translate_ids(ids)
    assert bulk.translate_id(1) == jst.translate_id(1)


def test_translate_store_load_entries():
    """Adopted entries keep their ids; later keys continue past the
    largest; a conflicting id is refused."""
    st = TranslateStore()
    st.apply_entries([("a", 4), ("b", 2)])
    assert st.translate_keys(["b", "c", "a", "d"]).tolist() == [2, 5, 4, 6]
    st.apply_entries([("a", 4)])
    with pytest.raises(ValueError, match="translate conflict"):
        st.apply_entries([("a", 3)])
    # An id far past the others, and the ids allocated after it.
    st.apply_entries([("far", 1 << 40)])
    assert st.translate_keys(["e", "far"]).tolist() == [(1 << 40) + 1,
                                                        1 << 40]
    assert st.translate_ids([2, 4, 6, 7, 1 << 40, (1 << 40) + 1,
                             (1 << 40) + 2]) == \
        ["b", "a", "d", None, "far", "e", None]
    assert st.translate_id(5) == "c" and st.size() == 6


@pytest.mark.parametrize("seed", [1, 2])
def test_attr_store_matches_jax(seed):
    """Merges, null deletes, emptied ids dropped, ids_matching and the
    mutation counter."""
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c"]
    values = [None, 1, 2, True, False, "x", "y", 1.5, [1, 2]]
    jst, st = JaxAttrStore(None), AttrStore()
    for _ in range(60):
        items = {int(i): {names[int(n)]: values[int(v)]
                          for n, v in zip(rng.integers(0, 3, 2),
                                          rng.integers(0, len(values), 2))}
                 for i in rng.integers(0, 12, int(rng.integers(1, 4)))}
        if len(items) == 1 and rng.random() < 0.5:
            (i, a), = items.items()
            jst.set(i, a)
            st.set(i, a)
        else:
            jst.set_bulk(items)
            st.set_bulk(items)
        assert st.attrs == jst.attrs
        assert st.gen == jst.gen
    for i in range(13):
        assert st.get(i) == jst.get(i)
    for name in names:
        for vals in ([1], [True], ["x", 2], [[1, 2]], 1.5, []):
            assert st.ids_matching(name, vals) == \
                jst.ids_matching(name, vals)


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """(JAX API, port API) over the same keyed, attributed data: loaded
    in the JAX package and carried over with load_state."""
    monkeypatch.setattr(megamod, "MEGAKERNEL_ENABLED", True)
    japi = jax_api(tmp_path)
    schema(japi)
    load(japi)
    tapi = API(load_state(Holder(device="cpu"), state_from_jax(japi.holder)))
    yield japi, tapi
    japi.holder.close()


def test_load_state_carries_keys_and_attrs(pair):
    japi, tapi = pair
    for name in ("repo", "u"):
        assert entries(tapi.holder.index(name)) == \
            entries(japi.holder.index(name))
    assert tapi.schema() == japi.schema()


def test_keyed_script_matches_jax_through_execute(pair):
    """Each request of the script through execute_full, one at a time:
    equal responses (keys, attrs, columnAttrs) and, after every
    request, equal ids and attributes."""
    japi, tapi = pair
    for pql in script():
        want = outcome(lambda: japi.executor.execute_full("repo", pql))
        got = outcome(lambda: tapi.executor.execute_full("repo", pql))
        assert got == want, pql
        assert entries(tapi.holder.index("repo")) == \
            entries(japi.holder.index("repo")), pql


def test_keyed_script_matches_jax_through_execute_batch(pair):
    """The whole script as one batch (its writes are fences; its reads
    of unknown keys allocate ids in request order), then a burst of
    reads that allocate keys, then a TopN after a SetRowAttrs that
    changes the allowed rows, in one batch too."""
    japi, tapi = pair
    reqs = [("repo", pql, None) for pql in script()]
    reqs += [("repo", f"Count(Row(stargazer='fresh{i}'))", None)
             for i in range(5)]
    reqs += [("repo", "Row(stargazer='fresh2')", None),
             ("repo", "TopN(stargazer, n=4, attrName='active', "
                      "attrValues=[true])", None),
             ("repo", "SetRowAttrs(stargazer, 'user0', active=false)",
              None),
             ("repo", "TopN(stargazer, n=4, attrName='active', "
                      "attrValues=[true])", None),
             ("u", "Row(f='x')", None), ("nope", "Row(f=1)", None)]

    def shaped(api):
        return [("error", str(r)) if isinstance(r, Exception) else r
                for r in api.executor.execute_batch_shaped(reqs)]
    want = shaped(japi)
    got = shaped(tapi)
    for (_, pql, _), g, w in zip(reqs, got, want):
        assert g == w, pql
    assert entries(tapi.holder.index("repo")) == \
        entries(japi.holder.index("repo"))


def test_keyed_index_filled_through_pql_matches_jax(tmp_path):
    """Both packages start empty and take the same keyed Sets and
    attribute writes through PQL; ids, attributes and answers match."""
    japi = jax_api(tmp_path)
    tapi = API(Holder(device="cpu"))
    users, repos, lang, _ = star_data(seed=5)
    writes = [" ".join(f"Set('{r}', stargazer='{u}')"
                       for u, r in zip(users[i:i + 40], repos[i:i + 40]))
              for i in range(0, 160, 40)]
    writes.append(" ".join(f"Set('{repo_key(i)}', language='{lang[i]}')"
                           for i in range(0, 60, 3)))
    writes.append("SetRowAttrs(stargazer, 'user2', active=true) "
                  "SetColumnAttrs('zz/top', url='z')")
    for api in (japi, tapi):
        schema(api)
        for q in writes:
            api.executor.execute("repo", q)
    assert entries(tapi.holder.index("repo")) == \
        entries(japi.holder.index("repo"))
    for pql in script()[:20]:
        assert outcome(lambda: tapi.executor.execute_full("repo", pql)) \
            == outcome(lambda: japi.executor.execute_full("repo", pql)), pql
    japi.holder.close()


ERRORS = [
    ("u", "Set('k', f=1)"),
    ("u", "Row(f='a')"),
    ("u", "Count(Row(f='a'))"),
    ("u", "Row(nofield='a')"),
    ("u", "Clear('k', f=1)"),
    ("u", "Set(1, f='a')"),
    ("u", "ClearRow(f='a')"),
    ("u", "Store(Row(f=1), f='a')"),
    ("u", "Rows(f, previous='a')"),
    ("u", "TopN(f, previous='a')"),
    ("u", "Rows(f, column='c')"),
    ("u", "GroupBy(Rows(f), previous=['a'])"),
    ("u", "GroupBy(Rows(f), previous=1)"),
    ("u", "GroupBy(Rows(f), previous=[1, 2])"),
    ("u", "GroupBy(Rows(f), filter=Row(f='a'))"),
    ("u", "SetRowAttrs(f, 'a', x=1)"),
    ("u", "SetColumnAttrs('c', x=1)"),
    ("u", "SetRowAttrs(nofield, 1, x=1)"),
    ("u", "TopN(f, Row(f='b'))"),
    ("u", "Options(Row(f='a'), excludeRowAttrs=true)"),
    ("u", "Options(Row(f=1), excludeRowAttrs=1)"),
    ("repo", "Row(plain='a')"),
    ("repo", "Set('c', plain='a')"),
    ("repo", "Rows(plain, previous='a')"),
    ("repo", "GroupBy(Rows(plain), previous=['a'])"),
    ("repo", "Row(stars='a')"),
    ("repo", "SetRowAttrs(plain, 'a', x=1)"),
    ("repo", "TopN(plain, previous='a')"),
    ("repo", "TopN(nofield, attrName='a', attrValues=[1])"),
]


def test_key_error_messages_match_jax(pair):
    """Every key error, on an unkeyed index and on unkeyed fields of a
    keyed index: the same message from both packages."""
    japi, tapi = pair
    for index, pql in ERRORS:
        want = outcome(lambda: japi.executor.execute(index, pql))
        got = outcome(lambda: tapi.executor.execute(index, pql))
        assert isinstance(want, tuple) and want[0] == "error", (pql, want)
        assert got == want, pql
    for name in ("repo", "u"):
        assert entries(tapi.holder.index(name)) == \
            entries(japi.holder.index(name))


IMPORTS = [
    # (method, index, field, keyword arguments)
    ("import_bits", "repo", "stargazer",
     {"rows": [1, 2], "column_keys": ["a", "b"]}),
    ("import_bits", "repo", "plain", {"rows": [1], "columns": [4]}),
    ("import_bits", "u", "f", {"rows": [1], "column_keys": ["a"]}),
    ("import_bits", "u", "f", {"row_keys": ["a"], "columns": [1]}),
    ("import_bits", "repo", "plain", {"row_keys": ["a"],
                                      "column_keys": ["x"]}),
    ("import_bits", "repo", "stargazer",
     {"row_keys": ["m1", "m2"], "column_keys": ["c1", "c2", "c3"]}),
    ("import_bits", "repo", "stargazer",
     {"row_keys": ["m3", "m1", "m3"], "column_keys": ["c3", "c9", "c1"]}),
    ("import_bits", "repo", "nofield", {"row_keys": ["a"],
                                        "column_keys": ["b"]}),
    ("import_values", "repo", "stars", {"columns": [1], "values": [4]}),
    ("import_values", "u", "f", {"column_keys": ["a"], "values": [4]}),
    ("import_values", "repo", "stars", {"column_keys": ["v1", "v2"],
                                        "values": [4]}),
    ("import_values", "repo", "stars", {"column_keys": ["v2", "v3"],
                                        "values": [4, 5000]}),
    ("import_values", "repo", "stars", {"column_keys": ["v3", "c9"],
                                        "values": [40, 50]}),
    ("import_bits", "repo", "stargazer",
     {"row_keys": ["m1"], "column_keys": ["c1"], "clear": True}),
]


def test_keyed_imports_match_jax(pair):
    """Keyed imports through both APIs, with mismatched ids and keys:
    the same errors, the same ids allocated (a failed import may still
    have allocated its keys, in both), the same answers after."""
    japi, tapi = pair
    for method, index, field, kw in IMPORTS:
        want = outcome(lambda: getattr(japi, method)(index, field, **kw))
        got = outcome(lambda: getattr(tapi, method)(index, field, **kw))
        assert got == want, (method, index, field, kw)
        assert entries(tapi.holder.index("repo")) == \
            entries(japi.holder.index("repo")), (method, kw)
    for pql in ("Row(stargazer='m1')", "Row(stargazer='m3')",
                "Sum(field=stars)", "Row(stars == 40)", "TopN(stargazer)"):
        assert tapi.executor.execute_full("repo", pql) == \
            japi.executor.execute_full("repo", pql), pql
    with pytest.raises(ApiError, match="does not use column keys"):
        tapi.import_bits("u", "f", rows=[1], column_keys=["a"])
