"""The BSBM data generator, written from the data-generation rules of the
Berlin SPARQL Benchmark V3.1 (Bizer and Schultz, IJSWIS 2009; the
specification's section on the benchmark dataset).

A configuration gives the number of products; every other count follows
from it by BSBM's ratios, which reproduce the specification's dataset
table (1M triples: 2,785 products, 151 product types, 4,745 features, 60
producers, 34 vendors, 55,700 offers, 1,432 reviewers, 27,850 reviews):

- product types form a tree whose depth and branching grow with the
  number of products; products sit on the leaves and carry ``rdf:type``
  for every type on their path, so a query for an inner type needs no
  inference;
- each non-root type owns its features; a product draws its features from
  those of the types on its path;
- 20 offers and 10 reviews a product; offers with vendor, price, validity,
  delivery days and web page; reviews with reviewer, date, title, text and
  four optional ratings; producers, vendors, reviewers and rating sites
  with their own records.

The generator builds no store: it returns a ``Graph`` of term strings or
numbers and int32 quads of indices into that list, which the harness hands
to the program through ``QuadStore.dict.encode_many`` and ``add_encoded``
and the reference reads as they are. What the specification leaves open,
or the engine cannot hold, the configuration lists under ``assumed``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Union

import numpy as np

Term = Union[str, int, float]

COUNTRIES = ("US", "GB", "JP", "CN", "DE", "FR", "ES", "RU", "KR", "AT")
CURRENT_DATE = 3000  # the generator's "today", in days; dates are day numbers


class Terms:
    """Insertion-ordered term list with the program's encode semantics: a
    term seen again keeps its first index."""

    def __init__(self) -> None:
        self._index: Dict[Term, int] = {}

    @property
    def items(self) -> List[Term]:
        return list(self._index)

    def encode(self, term: Term) -> int:
        return self._index.setdefault(term, len(self._index))

    def encode_many(self, terms) -> np.ndarray:
        index = self._index
        return np.asarray([index.setdefault(t, len(index)) for t in terms], np.int32)

    def numbers(self, values: np.ndarray, kind=int) -> np.ndarray:
        """Numeric terms: each distinct value encoded once."""
        uniq, inv = np.unique(values, return_inverse=True)
        return self.encode_many([kind(v) for v in uniq.tolist()])[inv.ravel()]


@dataclasses.dataclass
class Graph:
    terms: List[Term]
    quads: np.ndarray  # (n, 4) int32 indices into ``terms``: s, p, o, g
    meta: Dict[str, object]

    def lookup(self, term: Term) -> int:
        """The index of a term (a KeyError for one the graph lacks)."""
        if "_ids" not in self.__dict__:
            self.__dict__["_ids"] = {t: i for i, t in enumerate(self.terms)}
        return self.__dict__["_ids"][term]

    def _view(self, by: int):
        """Quads sorted by column ``by`` (then predicate, then the other
        end) and the offsets of each term's run in it."""
        key = f"_by{by}"
        if key not in self.__dict__:
            q = self.quads.astype(np.int64)
            n = len(self.terms)
            other = 2 - by
            rows = q[np.argsort((q[:, by] * (int(q[:, 1].max()) + 1) + q[:, 1]) * n + q[:, other],
                                kind="stable")][:, [by, 1, other]]
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(rows[:, 0], minlength=n), out=indptr[1:])
            self.__dict__[key] = (rows, indptr)
        return self.__dict__[key]

    def _match(self, by: int, node: int, pred: int = None) -> np.ndarray:
        rows, indptr = self._view(by)
        run = rows[indptr[node]: indptr[node + 1]]
        if pred is None:
            return run[:, 1:]
        lo, hi = np.searchsorted(run[:, 1], [pred, pred + 1])
        return run[lo:hi, 2]

    def objects(self, s: int, pred: Term) -> np.ndarray:
        """Objects of (s, pred, ?) as term indices."""
        return self._match(0, s, self.lookup(pred))

    def subjects(self, pred: Term, o: int) -> np.ndarray:
        """Subjects of (?, pred, o) as term indices, sorted."""
        return self._match(2, o, self.lookup(pred))

    def out_edges(self, s: int) -> np.ndarray:
        """(predicate, object) of every quad with subject ``s``."""
        return self._match(0, s)

    def in_edges(self, o: int) -> np.ndarray:
        """(predicate, subject) of every quad with object ``o``."""
        return self._match(2, o)


def _col(x, n):
    return np.full(n, x, np.int32)


def _words(rng, vocab: List[str], n: int, lo: int, hi: int) -> List[str]:
    """``n`` strings of ``lo`` to ``hi`` words of the vocabulary."""
    k = rng.randint(lo, hi + 1, n)
    w = rng.randint(0, len(vocab), (n, hi))
    return [" ".join(vocab[j] for j in row[:m]) for row, m in zip(w, k)]


def sizes(products: int) -> Dict[str, int]:
    """BSBM's counts for a number of products."""
    digits = round(math.log10(products))
    depth = digits // 2 + 1  # levels below the root
    branching = [2 * digits] + [8] * (depth - 2) + [24] if depth > 1 else [2 * digits]
    return dict(
        products=products,
        depth=depth,
        branching=branching,
        features=round(89.9 * math.sqrt(products)),
        producers=max(1, round(products * 60 / 2785)),
        vendors=max(1, round(products * 34 / 2785)),
        reviewers=max(1, round(products * 1432 / 2785)),
        offers=20 * products,
        reviews=10 * products,
    )


def bsbm_graph(products: int, seed: int) -> Graph:
    """A BSBM V3.1 dataset of ``products`` products, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    n = sizes(products)
    d = Terms()
    g = d.encode("inst:default")
    enc = d.encode
    vocab = sorted({"".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(3, 11)))
                    for _ in range(4000)})
    quads = []

    def add(s, p, o):
        s = np.asarray(s, np.int32)
        quads.append(np.stack([s, _col(enc(p), len(s)), np.asarray(o, np.int32),
                               _col(g, len(s))], 1))

    def strings(prefix, count):
        return d.encode_many(f"{prefix}{i}" for i in range(count))

    def literal(values):
        return d.encode_many(values)

    countries = literal(f"inst:{c}" for c in COUNTRIES)

    def dated(ids, publisher):
        add(ids, "dc:publisher", publisher)
        add(ids, "dc:date", d.numbers(CURRENT_DATE - rng.randint(0, 730, len(ids))))

    # the product type tree: level by level, each node's children in a run
    parents, levels = [np.array([-1])], [np.array([0])]
    for b in n["branching"]:
        last = levels[-1]
        parents.append(np.repeat(last, b))
        levels.append(np.arange(last[-1] + 1, last[-1] + 1 + len(last) * b))
    parent = np.concatenate(parents)
    n_type = len(parent)
    type_ids = np.concatenate([[enc("inst:ProductTypeRoot")], strings("inst:ProductType",
                                                                      n_type - 1)])
    # the path of each leaf, root excluded: ancestors[leaf, level]
    leaves = levels[-1]
    path = [leaves]
    for _ in range(n["depth"] - 1):
        path.append(parent[path[-1]])
    path = np.stack(path[::-1], 1)  # (n_leaf, depth), outermost first
    producer_ids = strings("inst:Producer", n["producers"])
    vendor_ids = strings("inst:Vendor", n["vendors"])
    site_ids = strings("inst:RatingSite", max(1, n["reviewers"] // 50))
    type_rows = np.arange(1, n_type)
    add(type_ids[type_rows], "rdf:type", _col(enc("bsbm:ProductType"), n_type - 1))
    add(type_ids[type_rows], "rdfs:subClassOf", type_ids[parent[type_rows]])
    add(type_ids, "rdfs:label", literal(_words(rng, vocab, n_type, 1, 2)))
    add(type_ids, "rdfs:comment", literal(_words(rng, vocab, n_type, 5, 12)))
    dated(type_ids, _col(producer_ids[0], n_type))

    # features: an equal share for each non-root type, in its type's order
    per_type = max(1, n["features"] // (n_type - 1))
    n_feat = per_type * (n_type - 1)
    feat_ids = strings("inst:ProductFeature", n_feat)
    add(feat_ids, "rdf:type", _col(enc("bsbm:ProductFeature"), n_feat))
    add(feat_ids, "rdfs:label", literal(_words(rng, vocab, n_feat, 1, 3)))
    add(feat_ids, "rdfs:comment", literal(_words(rng, vocab, n_feat, 5, 12)))
    dated(feat_ids, _col(producer_ids[0], n_feat))

    def agent(ids, cls, homepage):
        add(ids, "rdf:type", _col(enc(cls), len(ids)))
        add(ids, "rdfs:label", literal(_words(rng, vocab, len(ids), 1, 3)))
        add(ids, "rdfs:comment", literal(_words(rng, vocab, len(ids), 5, 12)))
        add(ids, "foaf:homepage", literal(f"http://www.{homepage}{i}.com/"
                                          for i in range(len(ids))))
        add(ids, "bsbm:country", countries[rng.randint(0, len(COUNTRIES), len(ids))])
        dated(ids, ids)

    agent(producer_ids, "bsbm:Producer", "producer")
    agent(vendor_ids, "bsbm:Vendor", "vendor")

    # products: a leaf type each, its path's types, features from the path
    P = n["products"]
    product_ids = strings("inst:Product", P)
    leaf = rng.randint(0, len(leaves), P)
    add(product_ids, "rdf:type", _col(enc("bsbm:Product"), P))
    for level in range(n["depth"]):
        add(product_ids, "rdf:type", type_ids[path[leaf, level]])
    add(product_ids, "rdfs:label", literal(_words(rng, vocab, P, 1, 3)))
    add(product_ids, "rdfs:comment", literal(_words(rng, vocab, P, 5, 20)))
    maker = producer_ids[rng.randint(0, len(producer_ids), P)]
    add(product_ids, "bsbm:producer", maker)
    pool = n["depth"] * per_type
    k = np.minimum(rng.randint(9, 22, P), pool)
    pick = np.argsort(rng.rand(P, pool), axis=1)[:, :21]
    keep = np.arange(pick.shape[1])[None, :] < k[:, None]
    level, offset = pick // per_type, pick % per_type
    feat = (path[leaf[:, None], level] - 1) * per_type + offset
    rows = np.repeat(np.arange(P), pick.shape[1])[keep.ravel()]
    add(product_ids[rows], "bsbm:productFeature", feat_ids[feat[keep]])
    for i in range(1, 7):
        have = np.ones(P, bool) if i <= 3 else rng.rand(P) < 0.5
        add(product_ids[have], f"bsbm:productPropertyNumeric{i}",
            d.numbers(rng.randint(1, 2001, have.sum())))
        have = np.ones(P, bool) if i <= 3 else rng.rand(P) < 0.5
        add(product_ids[have], f"bsbm:productPropertyTextual{i}",
            literal(_words(rng, vocab, int(have.sum()), 3, 15)))
    dated(product_ids, maker)

    # offers: 20 a product
    O = n["offers"]
    offer_ids = strings("inst:Offer", O)
    vendor = vendor_ids[rng.randint(0, len(vendor_ids), O)]
    add(offer_ids, "rdf:type", _col(enc("bsbm:Offer"), O))
    add(offer_ids, "bsbm:product", product_ids[np.repeat(np.arange(P), 20)])
    add(offer_ids, "bsbm:vendor", vendor)
    add(offer_ids, "bsbm:price", d.numbers(rng.randint(500, 1_000_001, O),
                                           lambda cents: round(cents / 100.0, 2)))
    start = CURRENT_DATE - rng.randint(0, 365, O)
    add(offer_ids, "bsbm:validFrom", d.numbers(start))
    add(offer_ids, "bsbm:validTo", d.numbers(start + rng.randint(1, 366, O)))
    add(offer_ids, "bsbm:deliveryDays", d.numbers(rng.randint(1, 22, O)))
    add(offer_ids, "bsbm:offerWebpage", literal(f"http://www.vendors.com/offers/Offer{i}"
                                                for i in range(O)))
    dated(offer_ids, vendor)

    # reviewers and reviews: 10 a product, each by a reviewer of a site
    R = n["reviewers"]
    reviewer_ids = strings("inst:Reviewer", R)
    site = site_ids[rng.randint(0, len(site_ids), R)]
    add(reviewer_ids, "rdf:type", _col(enc("foaf:Person"), R))
    add(reviewer_ids, "foaf:name", literal(_words(rng, vocab, R, 1, 2)))
    add(reviewer_ids, "foaf:mbox_sha1sum", literal(f"{x:040x}" for x in
                                                   rng.randint(0, 2**62, R, dtype=np.int64)))
    add(reviewer_ids, "bsbm:country", countries[rng.randint(0, len(COUNTRIES), R)])
    dated(reviewer_ids, site)
    add(site_ids, "rdf:type", _col(enc("bsbm:RatingSite"), len(site_ids)))
    add(site_ids, "rdfs:label", literal(_words(rng, vocab, len(site_ids), 1, 2)))
    add(site_ids, "foaf:homepage", literal(f"http://www.ratingsite{i}.com/"
                                           for i in range(len(site_ids))))
    V = n["reviews"]
    review_ids = strings("inst:Review", V)
    who = rng.randint(0, R, V)
    add(review_ids, "rdf:type", _col(enc("bsbm:Review"), V))
    add(review_ids, "bsbm:reviewFor", product_ids[np.repeat(np.arange(P), 10)])
    add(review_ids, "rev:reviewer", reviewer_ids[who])
    add(review_ids, "bsbm:reviewDate", d.numbers(CURRENT_DATE - rng.randint(0, 365, V)))
    add(review_ids, "dc:title", literal(_words(rng, vocab, V, 2, 8)))
    add(review_ids, "rev:text", literal(_words(rng, vocab, V, 5, 20)))
    for i in range(1, 5):
        have = rng.rand(V) < 0.7
        add(review_ids[have], f"bsbm:rating{i}", d.numbers(rng.randint(1, 11, have.sum())))
    dated(review_ids, site[who])

    quads = np.concatenate(quads, axis=0).astype(np.int32)
    # the features that the products of each non-root type carry, for the
    # traffic's feature parameters
    held = feat[keep]
    pairs = np.unique(np.concatenate([path[leaf[rows], lv] * n_feat + held
                                      for lv in range(n["depth"])]))
    terms = d.items
    type_features: Dict[str, List[str]] = {}
    for t, f in zip(pairs // n_feat, pairs % n_feat):
        type_features.setdefault(terms[type_ids[t]], []).append(terms[feat_ids[f]])
    meta = dict(n_product=P, n_offer=O, product_types=sorted(
        type_features, key=lambda t: int(t[len("inst:ProductType"):])),
                type_features=type_features)
    return Graph(terms, quads, meta)


def relabel(g: Graph, seed: int) -> Graph:
    """The same graph with its terms encoded in a seed-drawn order: every
    size, degree and answer stays, the term ids and so every index's
    physical order change."""
    perm = np.random.RandomState(seed).permutation(len(g.terms))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    terms = g.terms
    return Graph([terms[i] for i in perm.tolist()], inv[g.quads].astype(np.int32), g.meta)


def graph_for(config: dict, seed: int, products=None) -> Graph:
    """A configuration's graph for one run: the graph of its ``graph_seed``
    with its terms encoded in an order drawn from ``seed``."""
    products = config["products"] if products is None else products
    return relabel(bsbm_graph(products, config["graph_seed"]), seed)
