"""The BSBM V3.1 explore queries over the generated quads, in NumPy and
plain Python alone.

Each function takes the ``Graph`` and a request's constants and returns
the whole answer, before any ORDER BY, OFFSET or LIMIT (the judge applies
those), as a list of rows of terms in the order of the query's ``columns``;
an unbound variable is None. DISTINCT is applied here.
"""

from __future__ import annotations

import itertools

import numpy as np

from barqbench.reference.data import Graph


def _terms(g: Graph, ids):
    return [g.terms[int(i)] for i in ids]


def _one(g: Graph, s: int, pred: str):
    """The values of (s, pred, ?) as terms."""
    return _terms(g, g.objects(s, pred))


def _optional(values):
    return values if values else [None]


def _holders(g: Graph, pred: str, term: str) -> np.ndarray:
    return g.subjects(pred, g.lookup(term))


def _distinct(rows):
    return list(dict.fromkeys(rows))


def _typed_with(g: Graph, consts, features):
    prods = _holders(g, "rdf:type", consts["TYPE"])
    for f in features:
        prods = np.intersect1d(prods, _holders(g, "bsbm:productFeature", consts[f]))
    return prods


def q1(g, consts):
    """Products of a type with two features and productPropertyNumeric1 > X."""
    x = int(consts["X"])
    rows = [(g.terms[p], lab) for p in _typed_with(g, consts, ("FEATURE1", "FEATURE2"))
            for v in _one(g, p, "bsbm:productPropertyNumeric1") if v > x
            for lab in _one(g, p, "rdfs:label")]
    return _distinct(rows)


def q2(g, consts):
    """Everything a product page shows."""
    p = g.lookup(consts["PRODUCT"])
    makers = [m for m in g.objects(p, "bsbm:producer") if m in set(g.objects(p, "dc:publisher"))]
    parts = [
        _one(g, p, "rdfs:label"),
        _one(g, p, "rdfs:comment"),
        [lab for m in makers for lab in _one(g, m, "rdfs:label")],
        [lab for f in g.objects(p, "bsbm:productFeature") for lab in _one(g, f, "rdfs:label")],
        *[_one(g, p, f"bsbm:productPropertyTextual{i}") for i in (1, 2, 3)],
        *[_one(g, p, f"bsbm:productPropertyNumeric{i}") for i in (1, 2)],
        _optional(_one(g, p, "bsbm:productPropertyTextual4")),
        _optional(_one(g, p, "bsbm:productPropertyTextual5")),
        _optional(_one(g, p, "bsbm:productPropertyNumeric4")),
    ]
    return list(itertools.product(*parts))


def q3(g, consts):
    """Products of a type with one feature and without another, within two
    numeric bounds."""
    x, y = int(consts["X"]), int(consts["Y"])
    without = set(_holders(g, "bsbm:productFeature", consts["FEATURE2"]).tolist())
    rows = []
    for p in _typed_with(g, consts, ("FEATURE1",)):
        labels = _one(g, p, "rdfs:label")
        if p in without and labels:
            continue  # the OPTIONAL binds ?testVar
        for v1 in _one(g, p, "bsbm:productPropertyNumeric1"):
            for v3 in _one(g, p, "bsbm:productPropertyNumeric3"):
                if v1 > x and y > v3:
                    rows.extend((g.terms[p], lab) for lab in labels)
    return rows


def q4(g, consts):
    """The union of products of a type matching two sets of features."""
    rows = []
    for feats, num, bound in ((("FEATURE1", "FEATURE2"), 1, "X"),
                              (("FEATURE1", "FEATURE3"), 2, "Y")):
        for p in _typed_with(g, consts, feats):
            if any(v > int(consts[bound]) for v in _one(g, p, f"bsbm:productPropertyNumeric{num}")):
                rows.extend((g.terms[p], lab, t) for lab in _one(g, p, "rdfs:label")
                            for t in _one(g, p, "bsbm:productPropertyTextual1"))
    return _distinct(rows)


def q5(g, consts):
    """Products sharing a feature with a product and close to it in two
    numeric properties."""
    p = g.lookup(consts["PRODUCT"])
    cands = np.unique(np.concatenate(
        [g.subjects("bsbm:productFeature", f) for f in g.objects(p, "bsbm:productFeature")]
        or [np.zeros(0, np.int64)]))
    o1 = _one(g, p, "bsbm:productPropertyNumeric1")
    o2 = _one(g, p, "bsbm:productPropertyNumeric2")
    rows = []
    for q in cands:
        if q == p:
            continue
        ok1 = any(a + 120 > s > a - 120 for a in o1 for s in _one(g, q, "bsbm:productPropertyNumeric1"))
        ok2 = any(a + 170 > s > a - 170 for a in o2 for s in _one(g, q, "bsbm:productPropertyNumeric2"))
        if ok1 and ok2:
            rows.extend((g.terms[q], lab) for lab in _one(g, q, "rdfs:label"))
    return _distinct(rows)


def _reviews(g, p):
    return g.subjects("bsbm:reviewFor", p)


def q7(g, consts):
    """A product with its current offers from German vendors and its
    reviews."""
    p = g.lookup(consts["PRODUCT"])
    date = int(consts["DATE"])
    de = g.lookup("inst:DE")
    offers = []
    for o in g.subjects("bsbm:product", p):
        pub = set(g.objects(o, "dc:publisher").tolist())
        n_dates = sum(t > date for t in _one(g, o, "bsbm:validTo"))
        for v in g.objects(o, "bsbm:vendor"):
            if v in pub and de in g.objects(v, "bsbm:country"):
                offers.extend((g.terms[o], price, g.terms[v], title)
                              for price in _one(g, o, "bsbm:price")
                              for title in _one(g, v, "rdfs:label") for _ in range(n_dates))
    reviews = []
    for r in _reviews(g, p):
        for rv in g.objects(r, "rev:reviewer"):
            reviews.extend((g.terms[r], t, g.terms[rv], name, r1, r2)
                           for name in _one(g, rv, "foaf:name")
                           for t in _one(g, r, "dc:title")
                           for r1 in _optional(_one(g, r, "bsbm:rating1"))
                           for r2 in _optional(_one(g, r, "bsbm:rating2")))
    offers = offers or [(None,) * 4]
    reviews = reviews or [(None,) * 6]
    return [(lab, *o, *r) for lab in _one(g, p, "rdfs:label") for o in offers for r in reviews]


def q8(g, consts):
    """A product's reviews with their reviewers and ratings."""
    p = g.lookup(consts["PRODUCT"])
    rows = []
    for r in _reviews(g, p):
        for rv in g.objects(r, "rev:reviewer"):
            rows.extend(itertools.product(
                _one(g, r, "dc:title"), _one(g, r, "rev:text"), _one(g, r, "bsbm:reviewDate"),
                [g.terms[rv]], _one(g, rv, "foaf:name"),
                *[_optional(_one(g, r, f"bsbm:rating{i}")) for i in (1, 2, 3, 4)]))
    return rows


def q10(g, consts):
    """A product's current offers from US vendors that deliver within three
    days."""
    p = g.lookup(consts["PRODUCT"])
    date = int(consts["DATE"])
    us = g.lookup("inst:US")
    rows = []
    for o in g.subjects("bsbm:product", p):
        pub = set(g.objects(o, "dc:publisher").tolist())
        vendors = [v for v in g.objects(o, "bsbm:vendor")
                   if v in pub and us in g.objects(v, "bsbm:country")]
        if not vendors or not any(3 >= d for d in _one(g, o, "bsbm:deliveryDays")):
            continue
        if not any(t > date for t in _one(g, o, "bsbm:validTo")):
            continue
        rows.extend((g.terms[o], price) for price in _one(g, o, "bsbm:price"))
    return _distinct(rows)


def q11(g, consts):
    """Every quad an offer is the subject or the object of."""
    o = g.lookup(consts["OFFER"])
    out = [(g.terms[pr], g.terms[v], None) for pr, v in g.out_edges(o)]
    return out + [(g.terms[pr], None, g.terms[s]) for pr, s in g.in_edges(o)]
