"""Bundled minimal English pronunciation lexicon (ARPAbet, CMUdict conventions).

The reference delegates G2P to the ``g2p_en`` package (data.py:18-25), which ships
CMUdict + a neural fallback.  Neither is installable in a zero-egress image, so this
module bundles a hand-checked subset of high-frequency English words in CMUdict
notation (stress-marked vowels: 1 primary, 2 secondary, 0 reduced), plus simple
suffix morphology so inflected forms resolve through their stems.  Words not covered
fall through to the rule-based letter-to-sound engine in ``frontend.py``.

This is a data table, not code ported from anywhere; transcriptions follow the
public CMUdict phone set (the same inventory the reference's vocab is built from).
"""

from __future__ import annotations

# fmt: off
LEXICON: dict[str, tuple[str, ...]] = {
    # --- function words ---
    'a': ('AH0',), 'an': ('AE1', 'N'), 'the': ('DH', 'AH0',),
    'and': ('AH0', 'N', 'D'), 'or': ('AO1', 'R'), 'but': ('B', 'AH1', 'T'),
    'of': ('AH1', 'V'), 'to': ('T', 'UW1'), 'in': ('IH0', 'N'),
    'on': ('AA1', 'N'), 'at': ('AE1', 'T'), 'by': ('B', 'AY1'),
    'for': ('F', 'AO1', 'R'), 'with': ('W', 'IH1', 'DH'),
    'from': ('F', 'R', 'AH1', 'M'), 'up': ('AH1', 'P'),
    'out': ('AW1', 'T'), 'off': ('AO1', 'F'), 'over': ('OW1', 'V', 'ER0'),
    'under': ('AH1', 'N', 'D', 'ER0'), 'into': ('IH0', 'N', 'T', 'UW1'),
    'about': ('AH0', 'B', 'AW1', 'T'), 'after': ('AE1', 'F', 'T', 'ER0'),
    'before': ('B', 'IH0', 'F', 'AO1', 'R'), 'between': ('B', 'IH0', 'T', 'W', 'IY1', 'N'),
    'through': ('TH', 'R', 'UW1'), 'during': ('D', 'UH1', 'R', 'IH0', 'NG'),
    'against': ('AH0', 'G', 'EH1', 'N', 'S', 'T'),
    'above': ('AH0', 'B', 'AH1', 'V'), 'below': ('B', 'IH0', 'L', 'OW1'),
    'if': ('IH1', 'F'), 'then': ('DH', 'EH1', 'N'), 'than': ('DH', 'AE1', 'N'),
    'so': ('S', 'OW1'), 'as': ('AE1', 'Z'), 'because': ('B', 'IH0', 'K', 'AO1', 'Z'),
    'while': ('W', 'AY1', 'L'), 'when': ('W', 'EH1', 'N'),
    'where': ('W', 'EH1', 'R'), 'why': ('W', 'AY1'), 'how': ('HH', 'AW1'),
    'what': ('W', 'AH1', 'T'), 'which': ('W', 'IH1', 'CH'),
    'who': ('HH', 'UW1'), 'whom': ('HH', 'UW1', 'M'),
    'whose': ('HH', 'UW1', 'Z'), 'that': ('DH', 'AE1', 'T'),
    'this': ('DH', 'IH1', 'S'), 'these': ('DH', 'IY1', 'Z'),
    'those': ('DH', 'OW1', 'Z'), 'there': ('DH', 'EH1', 'R'),
    'here': ('HH', 'IY1', 'R'), 'not': ('N', 'AA1', 'T'),
    'no': ('N', 'OW1'), 'yes': ('Y', 'EH1', 'S'),
    'all': ('AO1', 'L'), 'any': ('EH1', 'N', 'IY0'),
    'some': ('S', 'AH1', 'M'), 'each': ('IY1', 'CH'),
    'every': ('EH1', 'V', 'ER0', 'IY0'), 'both': ('B', 'OW1', 'TH'),
    'few': ('F', 'Y', 'UW1'), 'more': ('M', 'AO1', 'R'),
    'most': ('M', 'OW1', 'S', 'T'), 'other': ('AH1', 'DH', 'ER0'),
    'such': ('S', 'AH1', 'CH'), 'only': ('OW1', 'N', 'L', 'IY0'),
    'own': ('OW1', 'N'), 'same': ('S', 'EY1', 'M'),
    'very': ('V', 'EH1', 'R', 'IY0'), 'just': ('JH', 'AH1', 'S', 'T'),
    'also': ('AO1', 'L', 'S', 'OW0'), 'too': ('T', 'UW1'),
    'again': ('AH0', 'G', 'EH1', 'N'), 'once': ('W', 'AH1', 'N', 'S'),
    'never': ('N', 'EH1', 'V', 'ER0'), 'always': ('AO1', 'L', 'W', 'EY2', 'Z'),
    'often': ('AO1', 'F', 'AH0', 'N'), 'now': ('N', 'AW1'),
    'well': ('W', 'EH1', 'L'), 'even': ('IY1', 'V', 'AH0', 'N'),
    'still': ('S', 'T', 'IH1', 'L'), 'however': ('HH', 'AW2', 'EH1', 'V', 'ER0'),
    # --- pronouns ---
    'i': ('AY1',), 'you': ('Y', 'UW1'), 'he': ('HH', 'IY1'),
    'she': ('SH', 'IY1'), 'it': ('IH1', 'T'), 'we': ('W', 'IY1'),
    'they': ('DH', 'EY1'), 'me': ('M', 'IY1'), 'him': ('HH', 'IH1', 'M'),
    'her': ('HH', 'ER1'), 'us': ('AH1', 'S'), 'them': ('DH', 'EH1', 'M'),
    'my': ('M', 'AY1'), 'your': ('Y', 'AO1', 'R'), 'his': ('HH', 'IH1', 'Z'),
    'its': ('IH1', 'T', 'S'), 'our': ('AW1', 'ER0'),
    'their': ('DH', 'EH1', 'R'), 'mine': ('M', 'AY1', 'N'),
    'myself': ('M', 'AY0', 'S', 'EH1', 'L', 'F'),
    'himself': ('HH', 'IH0', 'M', 'S', 'EH1', 'L', 'F'),
    'herself': ('HH', 'ER0', 'S', 'EH1', 'L', 'F'),
    'itself': ('IH0', 'T', 'S', 'EH1', 'L', 'F'),
    # --- be / have / do / modals ---
    'be': ('B', 'IY1'), 'am': ('AE1', 'M'), 'is': ('IH1', 'Z'),
    'are': ('AA1', 'R'), 'was': ('W', 'AA1', 'Z'), 'were': ('W', 'ER1'),
    'been': ('B', 'IH1', 'N'), 'being': ('B', 'IY1', 'IH0', 'NG'),
    'have': ('HH', 'AE1', 'V'), 'has': ('HH', 'AE1', 'Z'),
    'had': ('HH', 'AE1', 'D'), 'having': ('HH', 'AE1', 'V', 'IH0', 'NG'),
    'do': ('D', 'UW1'), 'does': ('D', 'AH1', 'Z'), 'did': ('D', 'IH1', 'D'),
    'done': ('D', 'AH1', 'N'), 'doing': ('D', 'UW1', 'IH0', 'NG'),
    'will': ('W', 'IH1', 'L'), 'would': ('W', 'UH1', 'D'),
    'can': ('K', 'AE1', 'N'), 'could': ('K', 'UH1', 'D'),
    'shall': ('SH', 'AE1', 'L'), 'should': ('SH', 'UH1', 'D'),
    'may': ('M', 'EY1'), 'might': ('M', 'AY1', 'T'),
    'must': ('M', 'AH1', 'S', 'T'), 'ought': ('AO1', 'T'),
    # --- common verbs ---
    'say': ('S', 'EY1'), 'said': ('S', 'EH1', 'D'), 'says': ('S', 'EH1', 'Z'),
    'go': ('G', 'OW1'), 'goes': ('G', 'OW1', 'Z'), 'went': ('W', 'EH1', 'N', 'T'),
    'gone': ('G', 'AO1', 'N'), 'going': ('G', 'OW1', 'IH0', 'NG'),
    'get': ('G', 'EH1', 'T'), 'got': ('G', 'AA1', 'T'),
    'make': ('M', 'EY1', 'K'), 'made': ('M', 'EY1', 'D'),
    'know': ('N', 'OW1'), 'knew': ('N', 'UW1'), 'known': ('N', 'OW1', 'N'),
    'think': ('TH', 'IH1', 'NG', 'K'), 'thought': ('TH', 'AO1', 'T'),
    'take': ('T', 'EY1', 'K'), 'took': ('T', 'UH1', 'K'),
    'taken': ('T', 'EY1', 'K', 'AH0', 'N'), 'see': ('S', 'IY1'),
    'saw': ('S', 'AO1'), 'seen': ('S', 'IY1', 'N'),
    'come': ('K', 'AH1', 'M'), 'came': ('K', 'EY1', 'M'),
    'want': ('W', 'AA1', 'N', 'T'), 'use': ('Y', 'UW1', 'Z'),
    'used': ('Y', 'UW1', 'Z', 'D'), 'find': ('F', 'AY1', 'N', 'D'),
    'found': ('F', 'AW1', 'N', 'D'), 'give': ('G', 'IH1', 'V'),
    'gave': ('G', 'EY1', 'V'), 'given': ('G', 'IH1', 'V', 'AH0', 'N'),
    'tell': ('T', 'EH1', 'L'), 'told': ('T', 'OW1', 'L', 'D'),
    'work': ('W', 'ER1', 'K'), 'call': ('K', 'AO1', 'L'),
    'try': ('T', 'R', 'AY1'), 'tried': ('T', 'R', 'AY1', 'D'),
    'ask': ('AE1', 'S', 'K'), 'need': ('N', 'IY1', 'D'),
    'feel': ('F', 'IY1', 'L'), 'felt': ('F', 'EH1', 'L', 'T'),
    'become': ('B', 'IH0', 'K', 'AH1', 'M'), 'became': ('B', 'IH0', 'K', 'EY1', 'M'),
    'leave': ('L', 'IY1', 'V'), 'left': ('L', 'EH1', 'F', 'T'),
    'put': ('P', 'UH1', 'T'), 'mean': ('M', 'IY1', 'N'),
    'meant': ('M', 'EH1', 'N', 'T'), 'keep': ('K', 'IY1', 'P'),
    'kept': ('K', 'EH1', 'P', 'T'), 'let': ('L', 'EH1', 'T'),
    'begin': ('B', 'IH0', 'G', 'IH1', 'N'), 'began': ('B', 'IH0', 'G', 'AE1', 'N'),
    'begun': ('B', 'IH0', 'G', 'AH1', 'N'), 'seem': ('S', 'IY1', 'M'),
    'help': ('HH', 'EH1', 'L', 'P'), 'talk': ('T', 'AO1', 'K'),
    'turn': ('T', 'ER1', 'N'), 'start': ('S', 'T', 'AA1', 'R', 'T'),
    'show': ('SH', 'OW1'), 'shown': ('SH', 'OW1', 'N'),
    'hear': ('HH', 'IY1', 'R'), 'heard': ('HH', 'ER1', 'D'),
    'play': ('P', 'L', 'EY1'), 'run': ('R', 'AH1', 'N'),
    'ran': ('R', 'AE1', 'N'), 'move': ('M', 'UW1', 'V'),
    'live': ('L', 'IH1', 'V'), 'believe': ('B', 'IH0', 'L', 'IY1', 'V'),
    'hold': ('HH', 'OW1', 'L', 'D'), 'held': ('HH', 'EH1', 'L', 'D'),
    'bring': ('B', 'R', 'IH1', 'NG'), 'brought': ('B', 'R', 'AO1', 'T'),
    'happen': ('HH', 'AE1', 'P', 'AH0', 'N'), 'write': ('R', 'AY1', 'T'),
    'wrote': ('R', 'OW1', 'T'), 'written': ('R', 'IH1', 'T', 'AH0', 'N'),
    'read': ('R', 'IY1', 'D'), 'sit': ('S', 'IH1', 'T'),
    'sat': ('S', 'AE1', 'T'), 'stand': ('S', 'T', 'AE1', 'N', 'D'),
    'stood': ('S', 'T', 'UH1', 'D'), 'lose': ('L', 'UW1', 'Z'),
    'lost': ('L', 'AO1', 'S', 'T'), 'pay': ('P', 'EY1'),
    'paid': ('P', 'EY1', 'D'), 'meet': ('M', 'IY1', 'T'),
    'met': ('M', 'EH1', 'T'), 'include': ('IH0', 'N', 'K', 'L', 'UW1', 'D'),
    'continue': ('K', 'AH0', 'N', 'T', 'IH1', 'N', 'Y', 'UW0'),
    'set': ('S', 'EH1', 'T'), 'learn': ('L', 'ER1', 'N'),
    'change': ('CH', 'EY1', 'N', 'JH'), 'lead': ('L', 'IY1', 'D'),
    'led': ('L', 'EH1', 'D'), 'understand': ('AH2', 'N', 'D', 'ER0', 'S', 'T', 'AE1', 'N', 'D'),
    'understood': ('AH2', 'N', 'D', 'ER0', 'S', 'T', 'UH1', 'D'),
    'watch': ('W', 'AA1', 'CH'), 'follow': ('F', 'AA1', 'L', 'OW0'),
    'stop': ('S', 'T', 'AA1', 'P'), 'create': ('K', 'R', 'IY0', 'EY1', 'T'),
    'speak': ('S', 'P', 'IY1', 'K'), 'spoke': ('S', 'P', 'OW1', 'K'),
    'spoken': ('S', 'P', 'OW1', 'K', 'AH0', 'N'),
    'open': ('OW1', 'P', 'AH0', 'N'), 'walk': ('W', 'AO1', 'K'),
    'win': ('W', 'IH1', 'N'), 'won': ('W', 'AH1', 'N'),
    'offer': ('AO1', 'F', 'ER0'), 'remember': ('R', 'IH0', 'M', 'EH1', 'M', 'B', 'ER0'),
    'love': ('L', 'AH1', 'V'), 'consider': ('K', 'AH0', 'N', 'S', 'IH1', 'D', 'ER0'),
    'appear': ('AH0', 'P', 'IH1', 'R'), 'buy': ('B', 'AY1'),
    'bought': ('B', 'AO1', 'T'), 'wait': ('W', 'EY1', 'T'),
    'serve': ('S', 'ER1', 'V'), 'die': ('D', 'AY1'),
    'send': ('S', 'EH1', 'N', 'D'), 'sent': ('S', 'EH1', 'N', 'T'),
    'build': ('B', 'IH1', 'L', 'D'), 'built': ('B', 'IH1', 'L', 'T'),
    'stay': ('S', 'T', 'EY1'), 'fall': ('F', 'AO1', 'L'),
    'fell': ('F', 'EH1', 'L'), 'fallen': ('F', 'AO1', 'L', 'AH0', 'N'),
    'cut': ('K', 'AH1', 'T'), 'reach': ('R', 'IY1', 'CH'),
    'kill': ('K', 'IH1', 'L'), 'raise': ('R', 'EY1', 'Z'),
    'pass': ('P', 'AE1', 'S'), 'sell': ('S', 'EH1', 'L'),
    'sold': ('S', 'OW1', 'L', 'D'), 'require': ('R', 'IY0', 'K', 'W', 'AY1', 'ER0'),
    'report': ('R', 'IH0', 'P', 'AO1', 'R', 'T'),
    'decide': ('D', 'IH0', 'S', 'AY1', 'D'), 'pull': ('P', 'UH1', 'L'),
    'jump': ('JH', 'AH1', 'M', 'P'), 'jumps': ('JH', 'AH1', 'M', 'P', 'S'),
    # --- common nouns ---
    'time': ('T', 'AY1', 'M'), 'year': ('Y', 'IH1', 'R'),
    'people': ('P', 'IY1', 'P', 'AH0', 'L'), 'way': ('W', 'EY1'),
    'day': ('D', 'EY1'), 'man': ('M', 'AE1', 'N'), 'men': ('M', 'EH1', 'N'),
    'woman': ('W', 'UH1', 'M', 'AH0', 'N'), 'women': ('W', 'IH1', 'M', 'AH0', 'N'),
    'child': ('CH', 'AY1', 'L', 'D'), 'children': ('CH', 'IH1', 'L', 'D', 'R', 'AH0', 'N'),
    'world': ('W', 'ER1', 'L', 'D'), 'life': ('L', 'AY1', 'F'),
    'hand': ('HH', 'AE1', 'N', 'D'), 'part': ('P', 'AA1', 'R', 'T'),
    'eye': ('AY1',), 'place': ('P', 'L', 'EY1', 'S'),
    'week': ('W', 'IY1', 'K'), 'case': ('K', 'EY1', 'S'),
    'point': ('P', 'OY1', 'N', 'T'), 'number': ('N', 'AH1', 'M', 'B', 'ER0'),
    'group': ('G', 'R', 'UW1', 'P'), 'problem': ('P', 'R', 'AA1', 'B', 'L', 'AH0', 'M'),
    'fact': ('F', 'AE1', 'K', 'T'), 'house': ('HH', 'AW1', 'S'),
    'home': ('HH', 'OW1', 'M'), 'water': ('W', 'AO1', 'T', 'ER0'),
    'room': ('R', 'UW1', 'M'), 'mother': ('M', 'AH1', 'DH', 'ER0'),
    'father': ('F', 'AA1', 'DH', 'ER0'), 'money': ('M', 'AH1', 'N', 'IY0'),
    'story': ('S', 'T', 'AO1', 'R', 'IY0'), 'month': ('M', 'AH1', 'N', 'TH'),
    'book': ('B', 'UH1', 'K'), 'word': ('W', 'ER1', 'D'),
    'business': ('B', 'IH1', 'Z', 'N', 'AH0', 'S'),
    'issue': ('IH1', 'SH', 'UW0'), 'side': ('S', 'AY1', 'D'),
    'kind': ('K', 'AY1', 'N', 'D'), 'head': ('HH', 'EH1', 'D'),
    'far': ('F', 'AA1', 'R'), 'service': ('S', 'ER1', 'V', 'AH0', 'S'),
    'friend': ('F', 'R', 'EH1', 'N', 'D'), 'hour': ('AW1', 'ER0'),
    'game': ('G', 'EY1', 'M'), 'line': ('L', 'AY1', 'N'),
    'end': ('EH1', 'N', 'D'), 'member': ('M', 'EH1', 'M', 'B', 'ER0'),
    'law': ('L', 'AO1'), 'car': ('K', 'AA1', 'R'),
    'city': ('S', 'IH1', 'T', 'IY0'), 'name': ('N', 'EY1', 'M'),
    'team': ('T', 'IY1', 'M'), 'minute': ('M', 'IH1', 'N', 'AH0', 'T'),
    'idea': ('AY0', 'D', 'IY1', 'AH0'), 'body': ('B', 'AA1', 'D', 'IY0'),
    'information': ('IH2', 'N', 'F', 'ER0', 'M', 'EY1', 'SH', 'AH0', 'N'),
    'back': ('B', 'AE1', 'K'), 'face': ('F', 'EY1', 'S'),
    'others': ('AH1', 'DH', 'ER0', 'Z'), 'level': ('L', 'EH1', 'V', 'AH0', 'L'),
    'office': ('AO1', 'F', 'AH0', 'S'), 'door': ('D', 'AO1', 'R'),
    'health': ('HH', 'EH1', 'L', 'TH'), 'person': ('P', 'ER1', 'S', 'AH0', 'N'),
    'art': ('AA1', 'R', 'T'), 'war': ('W', 'AO1', 'R'),
    'history': ('HH', 'IH1', 'S', 'T', 'ER0', 'IY0'),
    'party': ('P', 'AA1', 'R', 'T', 'IY0'), 'result': ('R', 'IH0', 'Z', 'AH1', 'L', 'T'),
    'morning': ('M', 'AO1', 'R', 'N', 'IH0', 'NG'),
    'reason': ('R', 'IY1', 'Z', 'AH0', 'N'),
    'research': ('R', 'IY0', 'S', 'ER1', 'CH'),
    'girl': ('G', 'ER1', 'L'), 'boy': ('B', 'OY1'),
    'moment': ('M', 'OW1', 'M', 'AH0', 'N', 'T'),
    'air': ('EH1', 'R'), 'teacher': ('T', 'IY1', 'CH', 'ER0'),
    'force': ('F', 'AO1', 'R', 'S'), 'education': ('EH2', 'JH', 'AH0', 'K', 'EY1', 'SH', 'AH0', 'N'),
    'foot': ('F', 'UH1', 'T'), 'feet': ('F', 'IY1', 'T'),
    'music': ('M', 'Y', 'UW1', 'Z', 'IH0', 'K'),
    'sound': ('S', 'AW1', 'N', 'D'), 'voice': ('V', 'OY1', 'S'),
    'speech': ('S', 'P', 'IY1', 'CH'), 'language': ('L', 'AE1', 'NG', 'G', 'W', 'AH0', 'JH'),
    'machine': ('M', 'AH0', 'SH', 'IY1', 'N'),
    'system': ('S', 'IH1', 'S', 'T', 'AH0', 'M'),
    'model': ('M', 'AA1', 'D', 'AH0', 'L'),
    'computer': ('K', 'AH0', 'M', 'P', 'Y', 'UW1', 'T', 'ER0'),
    'science': ('S', 'AY1', 'AH0', 'N', 'S'),
    'night': ('N', 'AY1', 'T'), 'light': ('L', 'AY1', 'T'),
    'question': ('K', 'W', 'EH1', 'S', 'CH', 'AH0', 'N'),
    'school': ('S', 'K', 'UW1', 'L'), 'state': ('S', 'T', 'EY1', 'T'),
    'family': ('F', 'AE1', 'M', 'AH0', 'L', 'IY0'),
    'student': ('S', 'T', 'UW1', 'D', 'AH0', 'N', 'T'),
    'country': ('K', 'AH1', 'N', 'T', 'R', 'IY0'),
    'president': ('P', 'R', 'EH1', 'Z', 'AH0', 'D', 'AH0', 'N', 'T'),
    'company': ('K', 'AH1', 'M', 'P', 'AH0', 'N', 'IY0'),
    'government': ('G', 'AH1', 'V', 'ER0', 'M', 'AH0', 'N', 'T'),
    'dog': ('D', 'AO1', 'G'), 'cat': ('K', 'AE1', 'T'),
    'fox': ('F', 'AA1', 'K', 'S'), 'bird': ('B', 'ER1', 'D'),
    'horse': ('HH', 'AO1', 'R', 'S'), 'tree': ('T', 'R', 'IY1'),
    'fire': ('F', 'AY1', 'ER0'), 'earth': ('ER1', 'TH'),
    'sun': ('S', 'AH1', 'N'), 'moon': ('M', 'UW1', 'N'),
    'star': ('S', 'T', 'AA1', 'R'), 'sea': ('S', 'IY1'),
    'river': ('R', 'IH1', 'V', 'ER0'), 'mountain': ('M', 'AW1', 'N', 'T', 'AH0', 'N'),
    'road': ('R', 'OW1', 'D'), 'rain': ('R', 'EY1', 'N'),
    'snow': ('S', 'N', 'OW1'), 'wind': ('W', 'IH1', 'N', 'D'),
    'paper': ('P', 'EY1', 'P', 'ER0'), 'letter': ('L', 'EH1', 'T', 'ER0'),
    'food': ('F', 'UW1', 'D'), 'bread': ('B', 'R', 'EH1', 'D'),
    'city': ('S', 'IH1', 'T', 'IY0'), 'street': ('S', 'T', 'R', 'IY1', 'T'),
    # --- adjectives / adverbs ---
    'good': ('G', 'UH1', 'D'), 'better': ('B', 'EH1', 'T', 'ER0'),
    'best': ('B', 'EH1', 'S', 'T'), 'bad': ('B', 'AE1', 'D'),
    'new': ('N', 'UW1'), 'old': ('OW1', 'L', 'D'),
    'great': ('G', 'R', 'EY1', 'T'), 'high': ('HH', 'AY1'),
    'low': ('L', 'OW1'), 'small': ('S', 'M', 'AO1', 'L'),
    'large': ('L', 'AA1', 'R', 'JH'), 'big': ('B', 'IH1', 'G'),
    'long': ('L', 'AO1', 'NG'), 'short': ('SH', 'AO1', 'R', 'T'),
    'little': ('L', 'IH1', 'T', 'AH0', 'L'), 'right': ('R', 'AY1', 'T'),
    'wrong': ('R', 'AO1', 'NG'), 'different': ('D', 'IH1', 'F', 'ER0', 'AH0', 'N', 'T'),
    'important': ('IH0', 'M', 'P', 'AO1', 'R', 'T', 'AH0', 'N', 'T'),
    'public': ('P', 'AH1', 'B', 'L', 'IH0', 'K'),
    'able': ('EY1', 'B', 'AH0', 'L'), 'early': ('ER1', 'L', 'IY0'),
    'late': ('L', 'EY1', 'T'), 'young': ('Y', 'AH1', 'NG'),
    'real': ('R', 'IY1', 'L'), 'sure': ('SH', 'UH1', 'R'),
    'free': ('F', 'R', 'IY1'), 'full': ('F', 'UH1', 'L'),
    'whole': ('HH', 'OW1', 'L'), 'easy': ('IY1', 'Z', 'IY0'),
    'hard': ('HH', 'AA1', 'R', 'D'), 'strong': ('S', 'T', 'R', 'AO1', 'NG'),
    'true': ('T', 'R', 'UW1'), 'white': ('W', 'AY1', 'T'),
    'black': ('B', 'L', 'AE1', 'K'), 'red': ('R', 'EH1', 'D'),
    'green': ('G', 'R', 'IY1', 'N'), 'blue': ('B', 'L', 'UW1'),
    'brown': ('B', 'R', 'AW1', 'N'), 'quick': ('K', 'W', 'IH1', 'K'),
    'slow': ('S', 'L', 'OW1'), 'lazy': ('L', 'EY1', 'Z', 'IY0'),
    'happy': ('HH', 'AE1', 'P', 'IY0'), 'fine': ('F', 'AY1', 'N'),
    'close': ('K', 'L', 'OW1', 'S'), 'open': ('OW1', 'P', 'AH0', 'N'),
    'next': ('N', 'EH1', 'K', 'S', 'T'), 'last': ('L', 'AE1', 'S', 'T'),
    'first': ('F', 'ER1', 'S', 'T'), 'second': ('S', 'EH1', 'K', 'AH0', 'N', 'D'),
    'third': ('TH', 'ER1', 'D'), 'together': ('T', 'AH0', 'G', 'EH1', 'DH', 'ER0'),
    'away': ('AH0', 'W', 'EY1'), 'around': ('ER0', 'AW1', 'N', 'D'),
    'almost': ('AO1', 'L', 'M', 'OW2', 'S', 'T'),
    'enough': ('IH0', 'N', 'AH1', 'F'), 'quite': ('K', 'W', 'AY1', 'T'),
    'really': ('R', 'IH1', 'L', 'IY0'), 'maybe': ('M', 'EY1', 'B', 'IY0'),
    'perhaps': ('P', 'ER0', 'HH', 'AE1', 'P', 'S'),
    'today': ('T', 'AH0', 'D', 'EY1'), 'tomorrow': ('T', 'AH0', 'M', 'AA1', 'R', 'OW2'),
    'yesterday': ('Y', 'EH1', 'S', 'T', 'ER0', 'D', 'EY2'),
    # --- numbers ---
    'zero': ('Z', 'IY1', 'R', 'OW0'), 'one': ('W', 'AH1', 'N'),
    'two': ('T', 'UW1'), 'three': ('TH', 'R', 'IY1'),
    'four': ('F', 'AO1', 'R'), 'five': ('F', 'AY1', 'V'),
    'six': ('S', 'IH1', 'K', 'S'), 'seven': ('S', 'EH1', 'V', 'AH0', 'N'),
    'eight': ('EY1', 'T'), 'nine': ('N', 'AY1', 'N'),
    'ten': ('T', 'EH1', 'N'), 'eleven': ('IH0', 'L', 'EH1', 'V', 'AH0', 'N'),
    'twelve': ('T', 'W', 'EH1', 'L', 'V'), 'twenty': ('T', 'W', 'EH1', 'N', 'T', 'IY0'),
    'thirty': ('TH', 'ER1', 'T', 'IY0'), 'forty': ('F', 'AO1', 'R', 'T', 'IY0'),
    'fifty': ('F', 'IH1', 'F', 'T', 'IY0'), 'hundred': ('HH', 'AH1', 'N', 'D', 'R', 'AH0', 'D'),
    'thousand': ('TH', 'AW1', 'Z', 'AH0', 'N', 'D'),
    'million': ('M', 'IH1', 'L', 'Y', 'AH0', 'N'),
    # --- greetings / misc ---
    'hello': ('HH', 'AH0', 'L', 'OW1'), 'hi': ('HH', 'AY1'),
    'goodbye': ('G', 'UH2', 'D', 'B', 'AY1'), 'please': ('P', 'L', 'IY1', 'Z'),
    'thank': ('TH', 'AE1', 'NG', 'K'), 'thanks': ('TH', 'AE1', 'NG', 'K', 'S'),
    'sorry': ('S', 'AA1', 'R', 'IY0'), 'okay': ('OW2', 'K', 'EY1'),
    'mister': ('M', 'IH1', 'S', 'T', 'ER0'), 'missus': ('M', 'IH1', 'S', 'AH0', 'Z'),
    'doctor': ('D', 'AA1', 'K', 'T', 'ER0'),
}
# fmt: on


_ES_AFTER = ('S', 'Z', 'SH', 'ZH', 'CH', 'JH')
_VOICELESS = ('P', 'T', 'K', 'F', 'TH', 'S', 'SH', 'CH', 'HH')


def _plural_suffix(last: str) -> tuple[str, ...]:
    """CMUdict-consistent -s/-es: /IH0 Z/ after sibilants, /S/ after voiceless,
    /Z/ otherwise."""
    if last in _ES_AFTER:
        return ('IH0', 'Z')
    if last in _VOICELESS:
        return ('S',)
    return ('Z',)


def lookup(word: str) -> tuple[str, ...] | None:
    """Lexicon lookup with light suffix morphology (plural -s/-es, -'s, -ing, -ed,
    -ly, -er).  Returns None when neither the word nor a derivable stem is known."""
    w = word.lower()
    if w in LEXICON:
        return LEXICON[w]
    if w.endswith("'s") and w[:-2] in LEXICON:
        base = LEXICON[w[:-2]]
        return base + _plural_suffix(base[-1])
    if w.endswith('s') and not w.endswith('ss') and w[:-1] in LEXICON:
        base = LEXICON[w[:-1]]
        return base + _plural_suffix(base[-1])
    if w.endswith('es') and w[:-2] in LEXICON:
        base = LEXICON[w[:-2]]
        return base + _plural_suffix(base[-1])
    if w.endswith('ing'):
        for stem in (w[:-3], w[:-3] + 'e', w[:-4]):   # walk+ing, make+ing, sitt+ing
            if stem in LEXICON:
                return LEXICON[stem] + ('IH0', 'NG')
    if w.endswith('ed'):
        for stem in (w[:-2], w[:-1], w[:-3]):         # walk+ed, raise+d, stopp+ed
            if stem in LEXICON:
                base = LEXICON[stem]
                if base[-1] in ('T', 'D'):
                    return base + ('IH0', 'D')
                if base[-1] in _VOICELESS:
                    return base + ('T',)
                return base + ('D',)
    if w.endswith('ly') and w[:-2] in LEXICON:
        return LEXICON[w[:-2]] + ('L', 'IY0')
    if w.endswith('er') and w[:-2] in LEXICON:
        return LEXICON[w[:-2]] + ('ER0',)
    return None


# ---------------------------------------------------------------------------
# Inverse lexicon: pronunciation → word (the ASR text-output direction).
# The forward table above is exactly the mapping to invert — no external data.
# ---------------------------------------------------------------------------

def _derived_spellings(w: str) -> list[str]:
    """Orthographic suffixed forms of ``w`` whose pronunciations ``lookup``
    can derive (plural/-'s, -ing, -ed, -ly, -er).  Standard spelling rules:
    final silent e drops before -ing/-ed/-er; sibilant finals take -es."""
    forms = []
    if w.endswith(('s', 'x', 'z', 'ch', 'sh')):
        forms.append(w + 'es')
    elif not w.endswith('s'):
        forms.append(w + 's')
    if w.endswith('e'):
        forms += [w[:-1] + 'ing', w + 'd', w + 'r']
    else:
        forms += [w + 'ing', w + 'ed', w + 'er']
    forms.append(w + 'ly')
    return forms


_INVERSE: dict[tuple[str, ...], str] | None = None
_MAX_PRON = 0

# Homophone tie-breaks the insertion order gets wrong (the table groups by part
# of speech, so e.g. 'knew' precedes 'new').  These spellings claim their
# pronunciation first; everything else resolves by insertion order.
_PREFERRED_SPELLINGS = ('the', 'a', 'to', 'new', 'no', 'know', 'see', 'one',
                        'here', 'there', 'for', 'by', 'right', 'sun')


def inverse_index() -> dict[tuple[str, ...], str]:
    """Pronunciation → word over the lexicon plus its derivable suffixed forms.

    Homophones (to/too/two, new/knew, see/sea) resolve to the most common
    spelling: an explicit preference list first, then LEXICON insertion order
    — deterministic either way.  Derived forms are verified through ``lookup``
    (the forward path) before insertion, so the index inverts exactly what the
    tokenizer can produce."""
    global _INVERSE, _MAX_PRON
    if _INVERSE is None:
        idx: dict[tuple[str, ...], str] = {}
        for w in _PREFERRED_SPELLINGS:
            if w in LEXICON:
                idx.setdefault(LEXICON[w], w)
        for w, pron in LEXICON.items():
            idx.setdefault(pron, w)
        for w in list(LEXICON):
            for form in _derived_spellings(w):
                pron = lookup(form)
                if pron is not None:
                    idx.setdefault(pron, form)
        _INVERSE = idx
        _MAX_PRON = max(len(p) for p in idx)
    return _INVERSE


def invert_phonemes(phones: tuple[str, ...]) -> list[str]:
    """One space-free phoneme group → word sequence.

    Exact match first; otherwise a forward Viterbi over the pronunciation
    trie minimizing (OOV phonemes, then word count) — so a group that is
    really two concatenated words ('DH AH0 K AE1 T') still segments, and
    spans no lexicon word covers come back as hyphen-joined raw ARPAbet
    ('K-AE1-T'), never silently dropped."""
    idx = inverse_index()
    if not phones:
        return []
    if phones in idx:
        return [idx[phones]]
    n = len(phones)
    inf = (n + 1, n + 1)
    dp: list[tuple[int, int]] = [inf] * (n + 1)
    dp[0] = (0, 0)
    back: list[tuple[int, str | None] | None] = [None] * (n + 1)
    for i in range(n):
        if dp[i] == inf:
            continue
        oov, words = dp[i]
        for j in range(i + 1, min(n, i + _MAX_PRON) + 1):
            w = idx.get(phones[i:j])
            if w is not None and (oov, words + 1) < dp[j]:
                dp[j] = (oov, words + 1)
                back[j] = (i, w)
        if (oov + 1, words + 1) < dp[i + 1]:       # OOV: consume one phoneme
            dp[i + 1] = (oov + 1, words + 1)
            back[i + 1] = (i, None)
    segs: list[str | None] = []
    j = n
    while j > 0:
        i, w = back[j]                              # dp[n] always reachable
        segs.append(w)
        j = i
    segs.reverse()
    out: list[str] = []
    oov_run: list[str] = []
    pos = 0
    for w in segs:
        if w is None:
            oov_run.append(phones[pos])
            pos += 1
            continue
        if oov_run:
            out.append('-'.join(oov_run))
            oov_run = []
        out.append(w)
        pos += len(lookup(w) or ())
    if oov_run:
        out.append('-'.join(oov_run))
    return out
