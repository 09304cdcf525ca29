"""Dictionary-backed lattice tokenizer for Japanese — Viterbi path over a
bundled lexicon.

The capability of the reference's vendored Kuromoji analyzer
(`deeplearning4j-nlp-japanese/src/main/java/com/atilika/kuromoji/viterbi/
ViterbiSearcher.java`, `ViterbiBuilder.java`, `dict/TokenInfoDictionary.java`,
`dict/UnknownDictionary.java`, `dict/ConnectionCosts.java`) at reduced
dictionary scale:

  * a bundled lexicon of high-frequency surface forms with word costs and
    coarse part-of-speech classes (Kuromoji: IPADIC token-info entries);
  * unknown-word edge generation by character script class — same-script
    runs become candidate edges with length-dependent costs (Kuromoji's
    `UnknownDictionary` + `CharacterDefinition` do exactly this);
  * a coarse-class connection-cost matrix (Kuromoji: the IPADIC
    left-id/right-id matrix, here collapsed to POS classes);
  * exact min-cost path by Viterbi DP over the lattice
    (`ViterbiSearcher.search`).

The lexicon is deliberately small (hundreds of entries, the closed-class
vocabulary plus very frequent content words): closed-class coverage is what
separates は-as-particle from は-inside-a-word, which is the failure mode of
script-run segmentation. Unknown open-class words are still segmented
correctly as script runs *between* the closed-class anchors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["LatticeTokenizer", "JA_LEXICON"]

# ---------------------------------------------------------------------------
# Coarse POS classes (collapsed left/right context ids)
# ---------------------------------------------------------------------------
NOUN = "N"          # nouns, pronouns, numbers
PART = "P"          # case/topic particles (postpositions)
VERB = "V"          # verb stems / conjugated forms
AUX = "A"           # auxiliaries, copula, polite endings
ADJ = "J"           # adjectives
ADV = "D"           # adverbs / conjunctions / interjections
SUF = "S"           # suffixes (counters, honorifics, nominalizers)
UNK = "U"           # unknown (script-run) words
BOS = "^"
EOS = "$"

# connection costs between coarse classes: row = left (previous word's
# class), col = right (next word's class). NON-NEGATIVE (0 = canonical
# bigram, larger = disfavored): negative "bonuses" would reward paths for
# taking MORE transitions — the same cost inversion that broke negative
# word costs (see _LEX_SRC note). Scale matches the word costs (~5-120).
#
# Round 5: when `resources/ja_costs.json` exists (written by
# experiments/train_ja_costs.py from the reference's vendored IPADIC
# dumps), the curated matrix below is REPLACED by learned bigram
# transition costs (-S ln P(c2|c1), smoothed) and the unknown-edge model
# by learned script/length statistics — the `ConnectionCosts.java` /
# `UnknownDictionary.java` analog actually estimated from data.
_CONN: Dict[Tuple[str, str], int] = {}
_CONN_DEFAULT = 30
_LEARNED = False


def _conn_default(a: str, b: str) -> int:
    return _CONN_DEFAULT


def _set(a: str, b: str, cost: int):
    _CONN[(a, b)] = cost


for _right in (NOUN, VERB, ADJ, ADV, UNK):
    _set(BOS, _right, 0)
_set(BOS, PART, 90)      # sentences rarely start with a particle
_set(BOS, AUX, 80)
_set(BOS, SUF, 90)
for _left in (NOUN, UNK, SUF):
    _set(_left, PART, 0)     # noun -> particle: the canonical bigram
    _set(_left, AUX, 5)      # noun -> copula (です/だ)
    _set(_left, SUF, 5)      # noun -> suffix (さん/たち/語)
    _set(_left, NOUN, 25)    # compound nouns exist but are dispreferred
    _set(_left, VERB, 15)
for _x in (NOUN, VERB, ADJ, ADV, UNK):
    _set(PART, _x, 0)        # particle -> content word
_set(PART, PART, 60)         # には/では are their own entries — chains of
_set(PART, AUX, 50)          # bare particles are almost always missegmented
                             # kana words (IPADIC encodes this in its ids)
_set(VERB, AUX, 0)           # verb stem -> ます/ました/たい
_set(VERB, VERB, 15)         # compound verbs / te-form chains
_set(VERB, PART, 5)          # 行くのは / 食べてから
_set(VERB, NOUN, 25)
_set(AUX, AUX, 0)            # まし+た / てい+ます chains
_set(AUX, EOS, 0)
_set(AUX, PART, 10)          # ですか/ですね (sentence-final particles)
_set(AUX, NOUN, 25)
_set(ADJ, NOUN, 0)           # adjective -> noun
_set(ADJ, AUX, 0)            # 大きいです
_set(ADV, VERB, 0)
for _left in (NOUN, VERB, AUX, UNK, SUF, PART, ADJ, ADV):
    _CONN.setdefault((_left, EOS), 0)


# ---------------------------------------------------------------------------
# Bundled lexicon: surface -> (cost, class). Lower cost = stronger word.
# Closed-class entries (particles/auxiliaries) carry very low costs so the
# Viterbi path anchors on them.
# ---------------------------------------------------------------------------
def _entries(cls: str, cost: int, words: str) -> List[Tuple[str, int, str]]:
    return [(w, cost, cls) for w in words.split()]


# Word costs are POSITIVE (the IPADIC convention): every edge adds cost,
# so fewer/longer words win by default and strong (frequent) words earn
# low costs. (Round-3's negative costs inverted this — once the lexicon
# grew past closed-class size, Viterbi exploded text into chains of
# single-char "particles" because more edges meant more negative total.)
_LEX_SRC: List[Tuple[str, int, str]] = []
# particles (case markers, topic, conjunctive)
_LEX_SRC += _entries(PART, 8, "は が を に で と へ も の や か ね よ "
                              "わ ぞ さ から まで より こそ しか でも "
                              "など って ば たり し のに ので けど "
                              "けれど ながら には では とは への")
# copula / polite auxiliaries / verbal endings — IPADIC token units only:
# the lattice composes ました as まし+た, でした as でし+た etc. (curated
# conjugated compounds would contradict the gold segmentation the F1 test
# measures against)
_LEX_SRC += _entries(AUX, 10, "です だ でし だっ ます まし ませ ん "
                              "ない なかっ たい たく て で た "
                              "いる い れる られる せる させる う よう "
                              "だろ でしょ らしい")
# demonstratives & pronouns
_LEX_SRC += _entries(NOUN, 25, "これ それ あれ どれ ここ そこ あそこ どこ "
                               "この その あの どの こちら そちら だれ 誰 "
                               "何 なに 私 僕 俺 君 彼 彼女 あなた 皆 "
                               "みんな 自分")
# very frequent nouns
_LEX_SRC += _entries(NOUN, 40, "人 日 時 年 月 今日 明日 昨日 今 時間 "
                               "学生 先生 学校 大学 会社 仕事 日本 日本語 "
                               "英語 東京 京都 国 家 水 本 車 電車 駅 道 "
                               "店 朝 昼 夜 天気 雨 映画 音楽 犬 猫 友達 "
                               "家族 母 父 子供 名前 話 気 手 目 心 上 下 "
                               "中 外 前 後 こと もの ところ ため")
# frequent verbs — dictionary forms, continuative stems, and 音便 stems
# (IPADIC units: 行った is 行っ + た, 読んで is 読ん + で)
_LEX_SRC += _entries(VERB, 35, "する し 行く 行き 行っ 来る 来 "
                               "食べる 食べ 飲む 飲み 飲ん 見る 見 "
                               "聞く 聞き 聞い 読む 読み 読ん "
                               "書く 書き 書い 話す 話し "
                               "思う 思い 思っ 言う 言い 言っ "
                               "使う 使い 使っ 持つ 持ち 持っ "
                               "作る 作り 作っ 分かる 分かり 分かっ "
                               "なる なり なっ 買う 買い 買っ 勉強 "
                               "働く 働き 働い 住む 住ん 会う 会い 会っ")
# adjectives
_LEX_SRC += _entries(ADJ, 40, "大きい 小さい 新しい 古い いい 良い 悪い "
                              "高い 安い 長い 短い 暑い 寒い 早い 遅い "
                              "多い 少ない 面白い 楽しい 難しい 簡単 綺麗 "
                              "きれい 元気 好き 嫌い 上手 下手 おいしい "
                              "美味しい")
# adverbs / conjunctions
_LEX_SRC += _entries(ADV, 40, "とても すこし 少し もう まだ また いつも "
                              "時々 たくさん ちょっと そして でも しかし "
                              "だから では はい いいえ")
# suffixes
_LEX_SRC += _entries(SUF, 30, "さん ちゃん 君 様 たち 達 語 人 中 的 年 "
                              "月 日 時 分 円 歳")

# frequent proper nouns (surnames/places — IPADIC's proper-noun entries;
# without them 田中 loses to 田+中(suffix))
_LEX_SRC += _entries(NOUN, 35, "田中 山田 鈴木 佐藤 高橋 伊藤 渡辺 中村 "
                               "小林 加藤 大阪 名古屋 横浜 北海道 九州 "
                               "沖縄 富士山 アメリカ 中国 韓国 フランス")
# hiragana spellings of common content words (kana-only text has no kanji
# anchors; IPADIC carries these as separate entries)
_LEX_SRC += _entries(NOUN, 40, "すし さかな ねこ いぬ ごはん みず おちゃ "
                               "ひと くるま うち こども")
_LEX_SRC += _entries(VERB, 40, "たべ たべる のむ のみ みる いく いき かう "
                               "かい よむ よみ はなし はなす")

JA_LEXICON: Dict[str, List[Tuple[int, str]]] = {}


def _load_freq_lexicon() -> int:
    """Merge the bundled lexicon (resources/ja_lexicon.tsv) into
    JA_LEXICON. Two formats: 3 columns (surface, count, class) gets the
    log-frequency cost recipe; 4 columns carries a LEARNED cost per
    (surface, class) — written by experiments/train_ja_costs.py from the
    reference's vendored Kuromoji/IPADIC output. Returns the number of
    entries loaded."""
    import math
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "resources", "ja_lexicon.tsv")
    n_loaded = 0
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return 0
    with f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 4:
                surf, n, cls, cost = parts
                JA_LEXICON.setdefault(surf, []).append((int(cost), cls))
            elif len(parts) == 3:
                surf, n, cls = parts
                # positive log-frequency cost (IPADIC recipe): the most
                # frequent surfaces approach the closed-class floor, rare
                # ones approach the unknown-edge region
                cost = max(6, int(100 - 12 * math.log(int(n) + 1)))
                JA_LEXICON.setdefault(surf, []).append((cost, cls))
            else:
                continue
            n_loaded += 1
    return n_loaded


def _load_learned_costs() -> bool:
    """Load learned connection + unknown-edge costs (ja_costs.json) if
    bundled; returns True when the learned tables replaced the curated
    ones."""
    import json
    import os

    global _CONN_DEFAULT, _LEARNED
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "resources", "ja_costs.json")
    # parse into FRESH dicts first and swap only on full success: a
    # malformed file must leave the curated tables intact (and the module
    # importable) rather than clearing _CONN halfway (review r5)
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        conn = {}
        for key, cost in data["conn"].items():
            a, b = key.split(" ")
            conn[(a, b)] = int(cost)
        unk = data["unk"]
        base = {k: int(v) for k, v in unk["base"].items()}
        per_char = {k: int(v) for k, v in unk["per_char"].items()}
        max_len = {k: max(4, int(v)) for k, v in unk["max_len"].items()}
        char_cost = {k: int(v)
                     for k, v in unk.get("char_cost", {}).items()}
        char_default = {k: int(v)
                        for k, v in unk.get("char_default", {}).items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return False
    _CONN.clear()
    _CONN.update(conn)
    _UNK_BASE.clear()
    _UNK_BASE.update(base)
    _UNK_PER_CHAR.clear()
    _UNK_PER_CHAR.update(per_char)
    _UNK_MAX_LEN.clear()
    _UNK_MAX_LEN.update(max_len)
    _UNK_CHAR_COST.clear()
    _UNK_CHAR_COST.update(char_cost)
    _UNK_CHAR_DEFAULT.clear()
    _UNK_CHAR_DEFAULT.update(char_default)
    # unseen transition on the learned scale ~= a very low-probability
    # bigram (the learned tables enumerate all class pairs, so this only
    # fires for exotic combinations)
    _CONN_DEFAULT = max(_CONN.values()) if _CONN else 30
    _LEARNED = True
    return True


_FREQ_ENTRIES = _load_freq_lexicon()


# ---------------------------------------------------------------------------
# Script classes for unknown-word edges (CharacterDefinition analog)
# ---------------------------------------------------------------------------
def _script(ch: str) -> str:
    cp = ord(ch)
    if 0x3041 <= cp <= 0x309F:
        return "hira"
    if 0x30A0 <= cp <= 0x30FF or cp == 0x30FC:
        return "kata"
    if 0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF:
        return "kanji"
    if ch.isalnum():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


# unknown-word base costs per script (Kuromoji UnknownDictionary invoke
# costs, coarsened; positive scale matching the dictionary costs):
# katakana/latin runs are usually one word (cheap long edges); kanji
# compounds favor short pieces; hiragana unknowns are heavily penalized
# (hiragana is closed-class territory — particles and endings should win).
_UNK_BASE = {"kanji": 60, "kata": 40, "latin": 30, "hira": 120}
_UNK_PER_CHAR = {"kanji": 25, "kata": 3, "latin": 2, "hira": 60}
_UNK_MAX_LEN = {"kanji": 4, "kata": 24, "latin": 48, "hira": 6}
# learned char-identity costs for unknown spans (-S ln P(ch|script); empty
# = curated flat per-char model)
_UNK_CHAR_COST: Dict[str, int] = {}
_UNK_CHAR_DEFAULT: Dict[str, int] = {}

# learned tables (if bundled) replace the curated connection/unknown
# costs; the curated hand-scale lexicon entries merge in ONLY when no
# learned model is present (their cost scale differs)
_load_learned_costs()
if not _LEARNED:
    for _w, _c, _cls in _LEX_SRC:
        _cost = _c
        if (len(_w) == 1 and _cls == NOUN
                and 0x4E00 <= ord(_w) <= 0x9FFF):
            # single-kanji nouns (日/中/本/人...) appear inside compounds
            # far more often than as standalone words — weaken them so
            # unknown compound runs (田中) stay whole
            _cost = 75
        JA_LEXICON.setdefault(_w, []).append((_cost, _cls))


class LatticeTokenizer:
    """Viterbi lattice tokenizer over a surface lexicon + unknown-word
    script edges. `tokenize` returns surface tokens; `tokenize_tagged`
    returns (surface, coarse_class) pairs."""

    def __init__(self, lexicon: Optional[Dict] = None):
        self.lexicon = lexicon if lexicon is not None else JA_LEXICON
        self._max_word = max((len(w) for w in self.lexicon), default=1)

    def _edges(self, text: str, i: int):
        """Candidate edges starting at position i: (end, cost, cls)."""
        out = []
        # dictionary edges
        for L in range(1, min(self._max_word, len(text) - i) + 1):
            surf = text[i:i + L]
            for cost, cls in self.lexicon.get(surf, ()):
                out.append((i + L, cost, cls))
        # unknown-word edges over same-script runs
        s = _script(text[i])
        if s in _UNK_BASE:
            run_end = i + 1
            while (run_end < len(text) and run_end - i < _UNK_MAX_LEN[s]
                   and _script(text[run_end]) == s):
                run_end += 1
            # emit prefixes of the run (kanji: each length; kata/latin:
            # prefer the full run, Kuromoji groups those scripts)
            lengths = (range(1, run_end - i + 1) if s in ("kanji", "hira")
                       else [run_end - i])
            for L in lengths:
                cost = _UNK_BASE[s] + _UNK_PER_CHAR[s] * L
                if _UNK_CHAR_COST:
                    # learned char-identity term: word-like characters
                    # make cheap unknown words (-S ln P(ch|script))
                    dflt = _UNK_CHAR_DEFAULT.get(s, 100)
                    cost += sum(_UNK_CHAR_COST.get(c2, dflt)
                                for c2 in text[i:i + L])
                out.append((i + L, cost, UNK))
        if not out:  # always offer the single char so the DP can't strand
            out.append((i + 1, 400, UNK))
        return out

    def tokenize_tagged(self, text: str) -> List[Tuple[str, str]]:
        toks: List[Tuple[str, str]] = []
        for seg in self._segments(text):
            # learned lattices use refined internal classes ("P:係助詞",
            # "V:連用形", ...); the public tag stays the coarse class
            toks.extend((s, c.split(":", 1)[0])
                        for s, c in self._viterbi(seg))
        return toks

    def tokenize(self, text: str) -> List[str]:
        return [t for t, _ in self.tokenize_tagged(text)]

    # -- internals -------------------------------------------------------
    def _segments(self, text: str) -> List[str]:
        """Split on whitespace/punctuation (lattice runs per segment, the
        way Kuromoji splits on its DOT/punctuation boundaries)."""
        segs, cur = [], []
        for ch in text:
            if _script(ch) in ("space", "punct"):
                if cur:
                    segs.append("".join(cur))
                    cur = []
            else:
                cur.append(ch)
        if cur:
            segs.append("".join(cur))
        return segs

    def _viterbi(self, seg: str) -> List[Tuple[str, str]]:
        n = len(seg)
        # best[i] = {cls: (cost, back_pos, back_cls, word)}
        best: List[Dict[str, Tuple[float, int, str, str]]] = [
            {} for _ in range(n + 1)]
        best[0][BOS] = (0.0, -1, "", "")
        for i in range(n):
            if not best[i]:
                continue
            for end, wcost, cls in self._edges(seg, i):
                surf = seg[i:end]
                for lcls, (lcost, *_rest) in best[i].items():
                    conn = _CONN.get((lcls, cls), _conn_default(lcls, cls))
                    tot = lcost + conn + wcost
                    cur = best[end].get(cls)
                    if cur is None or tot < cur[0]:
                        best[end][cls] = (tot, i, lcls, surf)
        # close with EOS
        final = None
        for lcls, (lcost, *_r) in best[n].items():
            tot = lcost + _CONN.get((lcls, EOS), _conn_default(lcls, EOS))
            if final is None or tot < final[0]:
                final = (tot, lcls)
        # backtrack
        out: List[Tuple[str, str]] = []
        pos, cls = n, final[1]
        while pos > 0:
            cost, back_pos, back_cls, surf = best[pos][cls]
            out.append((surf, cls))
            pos, cls = back_pos, back_cls
        out.reverse()
        return out
