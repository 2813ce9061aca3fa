"""BSBM-like e-commerce generator + Explore/BI query sets (paper §5,
Fig. 6b/6c), building the store on a device.

The Berlin SPARQL Benchmark [Bizer & Schultz '09] models an e-commerce
scenario: Products with types/features/producers, Offers from Vendors,
Reviews from Persons. The Explore use case is OLTP-style template queries
with selective constants (the overfetching stress test of §3.4 — the
example query of that section is reproduced as template E2); the BI use
case aggregates over larger slices.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.storage import QuadStore


def generate_ecommerce_graph(
    scale: float = 0.1, seed: int = 7, device=None
) -> Tuple[QuadStore, Dict[str, int]]:
    """The e-commerce graph as a store on ``device`` (None = the CUDA card).

    Shape mirrors BSBM: ~20 products per type, ~18 features per product,
    ~8 offers, ~2 reviews. About 200K triples per unit of scale (seed 7:
    scale 1 gives 199,186 triples, scale 36 gives 7,199,185 with 144,000
    products); the reference's docstring says 900K per unit, which its
    generator does not give. The same seed gives the same quads and
    dictionary codes as the reference package's generator (same
    ``np.random.RandomState`` stream)."""
    rng = np.random.RandomState(seed)
    n_product = max(int(4000 * scale), 100)
    n_type = max(n_product // 20, 5)
    n_feature = max(int(800 * scale), 40)
    n_producer = max(n_product // 40, 5)
    n_vendor = max(int(40 * scale), 5)
    n_person = max(int(300 * scale), 20)
    n_offer = n_product * 8
    n_review = n_product * 2

    store = QuadStore(device=device)
    d = store.dict
    P = lambda name: d.encode(name)  # noqa: E731

    product_ids = np.asarray([P(f":product{i}") for i in range(n_product)], np.int32)
    type_ids = np.asarray([P(f":ProductType{i}") for i in range(n_type)], np.int32)
    feat_ids = np.asarray([P(f":feature{i}") for i in range(n_feature)], np.int32)
    producer_ids = np.asarray([P(f":producer{i}") for i in range(n_producer)], np.int32)
    vendor_ids = np.asarray([P(f":vendor{i}") for i in range(n_vendor)], np.int32)
    person_ids = np.asarray([P(f":reviewer{i}") for i in range(n_person)], np.int32)
    offer_ids = np.asarray([P(f":offer{i}") for i in range(n_offer)], np.int32)
    review_ids = np.asarray([P(f":review{i}") for i in range(n_review)], np.int32)
    price_ids = np.asarray([P(int(p)) for p in range(1, 2001)], np.int32)
    rating_ids = np.asarray([P(int(r)) for r in range(1, 11)], np.int32)

    p_type = P("rdf:type")
    p_feature = P(":productFeature")
    p_producer = P(":producer")
    p_offer_product = P(":product")
    p_vendor = P(":vendor")
    p_price = P(":price")
    p_review_product = P(":reviewFor")
    p_reviewer = P(":reviewer")
    p_rating = P(":rating")
    g = P(":default")

    def col(x, n):
        return np.full(n, x, np.int32)

    quads = []
    # product -> type (skewed type popularity)
    types = rng.randint(0, n_type, n_product)
    quads.append(np.stack([product_ids, col(p_type, n_product), type_ids[types], col(g, n_product)], 1))
    # product -> features (~18)
    nf = n_product * 18
    pf_p = rng.randint(0, n_product, nf)
    pf_f = rng.randint(0, n_feature, nf)
    pf = np.unique(np.stack([pf_p, pf_f], 1), axis=0)
    quads.append(np.stack([product_ids[pf[:, 0]], col(p_feature, len(pf)), feat_ids[pf[:, 1]], col(g, len(pf))], 1))
    # product -> producer
    prod = rng.randint(0, n_producer, n_product)
    quads.append(np.stack([product_ids, col(p_producer, n_product), producer_ids[prod], col(g, n_product)], 1))
    # offers
    op = rng.randint(0, n_product, n_offer)
    quads.append(np.stack([offer_ids, col(p_offer_product, n_offer), product_ids[op], col(g, n_offer)], 1))
    ov = rng.randint(0, n_vendor, n_offer)
    quads.append(np.stack([offer_ids, col(p_vendor, n_offer), vendor_ids[ov], col(g, n_offer)], 1))
    oprice = rng.randint(0, 2000, n_offer)
    quads.append(np.stack([offer_ids, col(p_price, n_offer), price_ids[oprice], col(g, n_offer)], 1))
    # reviews
    rp = rng.randint(0, n_product, n_review)
    quads.append(np.stack([review_ids, col(p_review_product, n_review), product_ids[rp], col(g, n_review)], 1))
    rr = rng.randint(0, n_person, n_review)
    quads.append(np.stack([review_ids, col(p_reviewer, n_review), person_ids[rr], col(g, n_review)], 1))
    rrat = rng.randint(0, 10, n_review)
    quads.append(np.stack([review_ids, col(p_rating, n_review), rating_ids[rrat], col(g, n_review)], 1))

    store.add_encoded(np.concatenate(quads, axis=0))
    store.build()
    meta = dict(
        n_product=n_product,
        n_type=n_type,
        n_offer=n_offer,
        n_triples=store.n_quads,
    )
    return store, meta


# -- Explore use case: selective templates with a %TYPE%/%PRODUCT% placeholder
# (instantiated with random constants per run, as BSBM instantiates them) ----

BSBM_EXPLORE_TEMPLATES: Dict[str, str] = {
    # E1: products of a type with a given feature (BSBM Q1 analogue)
    "e1": """
        SELECT ?product {
          ?product rdf:type %TYPE% .
          ?product :productFeature ?feature .
          FILTER (?feature = %FEATURE%)
        } LIMIT 10
    """,
    # E2: the overfetching example of paper §3.4, verbatim shape
    "e2": """
        SELECT * {
          ?product rdf:type %TYPE% .
          ?product :productFeature ?feature .
          ?product :producer ?producer .
          ?offer :product ?product .
        }
    """,
    # E3: product detail point lookup (BSBM Q2 analogue)
    "e3": """
        SELECT ?feature ?producer {
          %PRODUCT% :productFeature ?feature .
          %PRODUCT% :producer ?producer .
        }
    """,
    # E4: offers for one product below a price (BSBM Q8 analogue)
    "e4": """
        SELECT ?offer ?price {
          ?offer :product %PRODUCT% .
          ?offer :price ?price .
          FILTER (?price < 500)
        }
    """,
    # E5: reviews for one product with ratings (BSBM Q7 analogue)
    "e5": """
        SELECT ?review ?rating ?reviewer {
          ?review :reviewFor %PRODUCT% .
          ?review :rating ?rating .
          ?review :reviewer ?reviewer .
        }
    """,
}


def instantiate_explore(template: str, meta: Dict[str, int], rng) -> str:
    q = template
    if "%TYPE%" in q:
        q = q.replace("%TYPE%", f":ProductType{rng.randint(meta['n_type'])}")
    if "%FEATURE%" in q:
        q = q.replace("%FEATURE%", ":feature0")
    if "%PRODUCT%" in q:
        q = q.replace("%PRODUCT%", f":product{rng.randint(meta['n_product'])}")
    return q


# -- BI use case: analytical aggregations (no selective constants) ------------

BSBM_BI_QUERIES: Dict[str, str] = {
    # B1: offer count + avg price per vendor
    "b1": """
        SELECT ?vendor (COUNT(*) AS ?offers) (AVG(?price) AS ?avgPrice) {
          ?offer :vendor ?vendor .
          ?offer :price ?price .
        } GROUP BY ?vendor
    """,
    # B2: products per type ordered by count (paper BI Q3 analogue: join-heavy)
    "b2": """
        SELECT ?type (COUNT(*) AS ?n) {
          ?product rdf:type ?type .
          ?product :productFeature ?feature .
        } GROUP BY ?type ORDER BY DESC(?n) LIMIT 10
    """,
    # B3: avg rating per producer (3-way join + aggregation)
    "b3": """
        SELECT ?producer (AVG(?rating) AS ?avg) {
          ?review :reviewFor ?product .
          ?review :rating ?rating .
          ?product :producer ?producer .
        } GROUP BY ?producer
    """,
    # B4: reviewers per vendor via shared products (amplifying join chain)
    "b4": """
        SELECT ?vendor (COUNT(DISTINCT ?reviewer) AS ?reviewers) {
          ?offer :vendor ?vendor .
          ?offer :product ?product .
          ?review :reviewFor ?product .
          ?review :reviewer ?reviewer .
        } GROUP BY ?vendor
    """,
    # B5: price stats per product type
    "b5": """
        SELECT ?type (MIN(?price) AS ?lo) (MAX(?price) AS ?hi) {
          ?product rdf:type ?type .
          ?offer :product ?product .
          ?offer :price ?price .
        } GROUP BY ?type
    """,
    # B6: feature co-occurrence volume (CPU-bound self join)
    "b6": """
        SELECT (COUNT(*) AS ?n) {
          ?p1 :productFeature ?f .
          ?p2 :productFeature ?f .
          FILTER (?p1 != ?p2)
        }
    """,
    # B7: high-rated products per vendor
    "b7": """
        SELECT ?vendor (COUNT(*) AS ?n) {
          ?offer :vendor ?vendor .
          ?offer :product ?product .
          ?review :reviewFor ?product .
          ?review :rating ?rating .
          FILTER (?rating >= 8)
        } GROUP BY ?vendor
    """,
    # B8: producers with no reviews (anti-join aggregate)
    "b8": """
        SELECT (COUNT(DISTINCT ?product) AS ?n) {
          ?product :producer ?producer .
          MINUS { ?review :reviewFor ?product }
        }
    """,
}
