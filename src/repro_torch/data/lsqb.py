"""LSQB-like social network generator + query set (paper §5, Fig. 6a).

LSQB [Mhedhbi et al., GRADES-NDA'21] measures join throughput on subgraph
counting queries over an LDBC-style social network, deliberately without
selective constants. We generate the same *shape* of data at configurable
scale: Person-knows-Person (heavy-tailed degree), Person-hasInterest-Tag,
Person-isLocatedIn-City, Person-studyAt-University, plus Comment/Post
replyOf edges for the larger queries. Queries Q1–Q9 mirror the LSQB
pattern structure (2-hop, stars, triangles, anti-joins); Q6 and Q9 are the
paper's motivating examples.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.storage import QuadStore


def _powerlaw_targets(rng, n: int, count: int, alpha: float = 1.6) -> np.ndarray:
    """Sample ``count`` targets in [0, n) with a heavy-tailed preference."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(n, size=count, p=probs)


def generate_social_graph(
    scale: float = 0.1, seed: int = 42, device=None
) -> Tuple[QuadStore, Dict[str, int]]:
    """The social graph as a store on ``device`` (None = the CUDA card).

    Measured sizes: scale 0.1 gives 4,425 triples and scale 20 gives
    912,324; scale 160 gives about 7.3M, the size of the paper's LSQB
    SF 0.3. The same seed gives the same quads and dictionary codes as the
    reference package's generator (same ``np.random.RandomState`` stream)."""
    rng = np.random.RandomState(seed)
    n_person = max(int(3000 * scale), 50)
    n_tag = max(int(300 * scale), 20)
    n_city = max(int(60 * scale), 10)
    n_univ = max(int(30 * scale), 5)
    n_msg = max(int(2000 * scale), 50)

    store = QuadStore(device=device)
    d = store.dict

    # pre-encode entity terms (bulk, vectorized loading path)
    person_ids = np.asarray([d.encode(f":person{i}") for i in range(n_person)], np.int32)
    tag_ids = np.asarray([d.encode(f":tag{i}") for i in range(n_tag)], np.int32)
    city_ids = np.asarray([d.encode(f":city{i}") for i in range(n_city)], np.int32)
    univ_ids = np.asarray([d.encode(f":univ{i}") for i in range(n_univ)], np.int32)
    msg_ids = np.asarray([d.encode(f":msg{i}") for i in range(n_msg)], np.int32)
    p_knows = d.encode(":knows")
    p_interest = d.encode(":hasInterest")
    p_located = d.encode(":isLocatedIn")
    p_study = d.encode(":studyAt")
    p_reply = d.encode(":replyOf")
    p_creator = d.encode(":hasCreator")
    p_type = d.encode("rdf:type")
    c_person = d.encode(":Person")
    c_msg = d.encode(":Message")
    g = d.encode(":default")

    quads = []

    # knows: ~avg degree 18, heavy-tailed, deduped, no self-loops
    n_knows = n_person * 18
    src = rng.randint(0, n_person, n_knows)
    dst = _powerlaw_targets(rng, n_person, n_knows)
    ok = src != dst
    knows = np.unique(np.stack([src[ok], dst[ok]], axis=1), axis=0)
    quads.append(
        np.stack(
            [
                person_ids[knows[:, 0]],
                np.full(len(knows), p_knows, np.int32),
                person_ids[knows[:, 1]],
                np.full(len(knows), g, np.int32),
            ],
            axis=1,
        )
    )

    # interests: ~4 per person, skewed tags
    n_int = n_person * 4
    ps = rng.randint(0, n_person, n_int)
    ts = _powerlaw_targets(rng, n_tag, n_int)
    ints = np.unique(np.stack([ps, ts], axis=1), axis=0)
    quads.append(
        np.stack(
            [
                person_ids[ints[:, 0]],
                np.full(len(ints), p_interest, np.int32),
                tag_ids[ints[:, 1]],
                np.full(len(ints), g, np.int32),
            ],
            axis=1,
        )
    )

    # city / university / types
    cities = rng.randint(0, n_city, n_person)
    quads.append(
        np.stack(
            [
                person_ids,
                np.full(n_person, p_located, np.int32),
                city_ids[cities],
                np.full(n_person, g, np.int32),
            ],
            axis=1,
        )
    )
    study_mask = rng.rand(n_person) < 0.6
    sp = person_ids[study_mask]
    quads.append(
        np.stack(
            [
                sp,
                np.full(len(sp), p_study, np.int32),
                univ_ids[rng.randint(0, n_univ, len(sp))],
                np.full(len(sp), g, np.int32),
            ],
            axis=1,
        )
    )
    quads.append(
        np.stack(
            [
                person_ids,
                np.full(n_person, p_type, np.int32),
                np.full(n_person, c_person, np.int32),
                np.full(n_person, g, np.int32),
            ],
            axis=1,
        )
    )

    # messages: creator + reply chains
    creators = rng.randint(0, n_person, n_msg)
    quads.append(
        np.stack(
            [
                msg_ids,
                np.full(n_msg, p_creator, np.int32),
                person_ids[creators],
                np.full(n_msg, g, np.int32),
            ],
            axis=1,
        )
    )
    reply_to = rng.randint(0, n_msg, n_msg)
    ok = reply_to < np.arange(n_msg)  # DAG
    rm = msg_ids[ok]
    quads.append(
        np.stack(
            [
                rm,
                np.full(len(rm), p_reply, np.int32),
                msg_ids[reply_to[ok]],
                np.full(len(rm), g, np.int32),
            ],
            axis=1,
        )
    )
    quads.append(
        np.stack(
            [
                msg_ids,
                np.full(n_msg, p_type, np.int32),
                np.full(n_msg, c_msg, np.int32),
                np.full(n_msg, g, np.int32),
            ],
            axis=1,
        )
    )

    store.add_encoded(np.concatenate(quads, axis=0))
    store.build()
    meta = dict(
        n_person=n_person,
        n_tag=n_tag,
        n_knows=len(knows),
        n_triples=store.n_quads,
    )
    return store, meta


# LSQB-analogue queries. Q6/Q9 are the paper's motivating examples
# (Figure 1 / Listing 1 / Listing 5).
LSQB_QUERIES: Dict[str, str] = {
    # Q1: 1-hop neighbourhood with interests (simple star)
    "q1": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :knows ?p2 .
          ?p2 :hasInterest ?tag .
        }
    """,
    # Q2: co-location pairs
    "q2": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :isLocatedIn ?city .
          ?p2 :isLocatedIn ?city .
          FILTER (?p1 != ?p2)
        }
    """,
    # Q3: triangles with interest restriction
    "q3": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :knows ?p2 .
          ?p2 :knows ?p3 .
          ?p3 :knows ?p1 .
          ?p1 :hasInterest ?tag .
        }
    """,
    # Q4: message reply chains to creators
    "q4": """
        SELECT (COUNT(*) AS ?count) {
          ?m1 :replyOf ?m2 .
          ?m2 :hasCreator ?p .
          ?p :hasInterest ?tag .
        }
    """,
    # Q5: 2-hop with university co-study
    "q5": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :studyAt ?u .
          ?p2 :studyAt ?u .
          ?p1 :knows ?p2 .
        }
    """,
    # Q6: the paper's motivating example (Figure 1): directed 2-hop paths
    # with interest tags, excluding trivial cycles
    "q6": """
        SELECT (COUNT(*) AS ?count) {
          ?person1 :knows ?person2 .
          ?person2 :knows ?person3 .
          ?person3 :hasInterest ?tag .
          FILTER (?person1 != ?person3)
        }
    """,
    # Q7: optional interests over 2-hop (left join load)
    "q7": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :knows ?p2 .
          OPTIONAL { ?p2 :hasInterest ?tag }
        }
    """,
    # Q8: co-interest without acquaintance (anti-join)
    "q8": """
        SELECT (COUNT(*) AS ?count) {
          ?p1 :hasInterest ?t .
          ?p2 :hasInterest ?t .
          FILTER (?p1 != ?p2)
          MINUS { ?p1 :knows ?p2 }
        }
    """,
    # Q9: Q6 plus FILTER NOT EXISTS triangle elimination (paper §5.2:
    # 'Q9 just adds a FILTER NOT EXISTS condition'; Stardog evaluates it
    # with the MINUS anti-join)
    "q9": """
        SELECT (COUNT(*) AS ?count) {
          ?person1 :knows ?person2 .
          ?person2 :knows ?person3 .
          ?person3 :hasInterest ?tag .
          FILTER (?person1 != ?person3)
          MINUS { ?person3 :knows ?person1 }
        }
    """,
}
