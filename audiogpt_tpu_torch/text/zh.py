"""Chinese text frontend: normalisation, hanzi → pinyin, and pinyin →
initial / final phones.

Counterpart of ``audiogpt_tpu/text/zh.py`` (the reference's
``NeuralSeq/utils/text_norm.py`` normaliser and
``NeuralSeq/data_gen/tts/txt_processors/zh.py``): non-standard words
(numbers, decimals, percents, years, dates, times, fractions, ranges, phone
numbers) are rewritten as hanzi; each character takes its pinyin from the
phrase table (context polyphones), the curated lexicon or the bundled
CLDR-derived table (``text/data/zh_lexicon.tsv.gz``, this package's own
copy, 19.5k characters), or an optional user TSV; a syllable splits into
its initial and its final (tone digit kept). :class:`ZhTTSFrontend` gives
the binarizer's ``ProcessedText`` (hanzi and pinyin words, ``|`` word
boundaries), which ``data/binarizer.py`` ``ZhBinarizer`` reads. The SVS
engines split score syllables with :func:`split_pinyin`.
"""

from __future__ import annotations

import gzip
import os
import re

INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g",
            "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w"]

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_BIG_UNITS = ["", "万", "亿", "万亿"]

# Built-in mini-lexicon: common chars (incl. the default-song lyrics).
_BUILTIN_LEXICON = {
    "你": "ni3", "我": "wo3", "他": "ta1", "她": "ta1", "们": "men2",
    "的": "de5", "了": "le5", "是": "shi4", "在": "zai4", "有": "you3",
    "不": "bu4", "人": "ren2", "这": "zhe4", "中": "zhong1", "大": "da4",
    "来": "lai2", "上": "shang4", "国": "guo2", "个": "ge4", "到": "dao4",
    "说": "shuo1", "们": "men2", "为": "wei4", "子": "zi3", "和": "he2",
    "你": "ni3", "地": "di4", "出": "chu1", "道": "dao4", "也": "ye3",
    "时": "shi2", "年": "nian2", "得": "de2", "就": "jiu4", "那": "na4",
    "要": "yao4", "下": "xia4", "以": "yi3", "生": "sheng1", "会": "hui4",
    "自": "zi4", "着": "zhe5", "去": "qu4", "之": "zhi1", "过": "guo4",
    "家": "jia1", "学": "xue2", "对": "dui4", "可": "ke3", "她": "ta1",
    "里": "li3", "后": "hou4", "小": "xiao3", "么": "me5", "心": "xin1",
    "多": "duo1", "天": "tian1", "而": "er2", "能": "neng2", "好": "hao3",
    "都": "dou1", "然": "ran2", "没": "mei2", "日": "ri4", "于": "yu2",
    "起": "qi3", "还": "hai2", "发": "fa1", "成": "cheng2", "事": "shi4",
    "只": "zhi3", "作": "zuo4", "当": "dang1", "想": "xiang3", "看": "kan4",
    "文": "wen2", "无": "wu2", "开": "kai1", "手": "shou3", "十": "shi2",
    "用": "yong4", "主": "zhu3", "行": "xing2", "方": "fang1", "又": "you4",
    "如": "ru2", "前": "qian2", "所": "suo3", "本": "ben3", "见": "jian4",
    "经": "jing1", "头": "tou2", "面": "mian4", "公": "gong1", "同": "tong2",
    "三": "san1", "已": "yi3", "老": "lao3", "从": "cong2", "动": "dong4",
    "两": "liang3", "长": "chang2", "知": "zhi1", "民": "min2", "样": "yang4",
    "现": "xian4", "分": "fen1", "将": "jiang1", "外": "wai4", "但": "dan4",
    "身": "shen1", "些": "xie1", "与": "yu3", "高": "gao1", "意": "yi4",
    "进": "jin4", "把": "ba3", "法": "fa3", "此": "ci3", "实": "shi2",
    "回": "hui2", "二": "er4", "理": "li3", "美": "mei3", "点": "dian3",
    "月": "yue4", "明": "ming2", "其": "qi2", "种": "zhong3", "声": "sheng1",
    "全": "quan2", "工": "gong1", "己": "ji3", "话": "hua4", "儿": "er2",
    "者": "zhe3", "向": "xiang4", "情": "qing2", "部": "bu4", "正": "zheng4",
    "名": "ming2", "定": "ding4", "女": "nv3", "问": "wen4", "力": "li4",
    "机": "ji1", "给": "gei3", "等": "deng3", "几": "ji3", "很": "hen3",
    "业": "ye4", "最": "zui4", "间": "jian1", "新": "xin1", "什": "shen2",
    "打": "da3", "便": "bian4", "位": "wei4", "因": "yin1", "重": "zhong4",
    "被": "bei4", "走": "zou3", "电": "dian4", "四": "si4", "第": "di4",
    "门": "men2", "相": "xiang1", "次": "ci4", "东": "dong1", "政": "zheng4",
    "海": "hai3", "口": "kou3", "使": "shi3", "教": "jiao4", "西": "xi1",
    "再": "zai4", "平": "ping2", "真": "zhen1", "听": "ting1", "世": "shi4",
    "气": "qi4", "信": "xin4", "北": "bei3", "少": "shao3", "关": "guan1",
    "并": "bing4", "内": "nei4", "加": "jia1", "化": "hua4", "由": "you2",
    "却": "que4", "代": "dai4", "军": "jun1", "产": "chan3", "入": "ru4",
    "先": "xian1", "山": "shan1", "五": "wu3", "太": "tai4", "水": "shui3",
    "万": "wan4", "市": "shi4", "眼": "yan3", "体": "ti3", "别": "bie2",
    "处": "chu4", "总": "zong3", "才": "cai2", "场": "chang3", "师": "shi1",
    "书": "shu1", "比": "bi3", "住": "zhu4", "员": "yuan2", "九": "jiu3",
    "笑": "xiao4", "性": "xing4", "通": "tong1", "目": "mu4", "华": "hua2",
    "报": "bao4", "立": "li4", "马": "ma3", "命": "ming4", "张": "zhang1",
    "活": "huo2", "难": "nan2", "神": "shen2", "数": "shu4", "件": "jian4",
    "安": "an1", "表": "biao3", "原": "yuan2", "车": "che1", "白": "bai2",
    "应": "ying1", "路": "lu4", "期": "qi1", "叫": "jiao4", "死": "si3",
    "常": "chang2", "提": "ti2", "感": "gan3", "金": "jin1", "何": "he2",
    "更": "geng4", "反": "fan3", "题": "ti2", "必": "bi4", "都": "dou1",
    "风": "feng1", "族": "zu2", "唱": "chang4", "歌": "ge1", "音": "yin1",
    "乐": "yue4", "爱": "ai4", "梦": "meng4", "花": "hua1", "雨": "yu3",
    "云": "yun2", "夜": "ye4", "星": "xing1", "光": "guang1", "春": "chun1",
    "秋": "qiu1", "冬": "dong1", "夏": "xia4", "红": "hong2", "青": "qing1",
    "字": "zi4", "六": "liu4", "七": "qi1", "八": "ba1", "百": "bai3",
    "千": "qian1", "亿": "yi4", "零": "ling2", "懂": "dong3", "牵": "qian1",
    "候": "hou4", "空": "kong1", "远": "yuan3", "近": "jin4", "深": "shen1",
}


# ---------------------------------------------------------------------------
# Number normalization (text_norm.py NSWNormalizer semantics, compact)
# ---------------------------------------------------------------------------


def num_to_hanzi(n: int) -> str:
    """Cardinal integer → hanzi reading (e.g. 205 → 二百零五, 10 → 十)."""
    if n == 0:
        return _DIGITS[0]
    if n < 0:
        return "负" + num_to_hanzi(-n)
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        s = ""
        zero_pending = False
        for ui in range(3, -1, -1):
            d = (g // 10 ** ui) % 10
            if d == 0:
                if s:
                    zero_pending = True
                continue
            if zero_pending:
                s += _DIGITS[0]
                zero_pending = False
            s += _DIGITS[d] + _UNITS[ui]
        # 一十X → 十X for the leading tens of the most significant group
        if gi == len(groups) - 1 and s.startswith("一十"):
            s = s[1:]
        parts.append(s + _BIG_UNITS[gi])
        # inter-group zero (e.g. 100000001)
        if gi > 0 and groups[gi - 1] != 0 and groups[gi - 1] < 1000:
            parts.append(_DIGITS[0])
    return "".join(parts).rstrip(_DIGITS[0]) or _DIGITS[0]


def digits_to_hanzi(s: str) -> str:
    """Digit-by-digit reading (phone numbers, years): 2024 → 二零二四."""
    return "".join(_DIGITS[int(c)] if c.isdigit() else c for c in s)


# fullwidth → halfwidth, same table as the reference processor
# (txt_processors/zh.py:10-12)
_FULLWIDTH = {ord(f): ord(t) for f, t in zip(
    "：，。！？【】（）％＃＠＆１２３４５６７８９０",
    ":,.!?[]()%#@&1234567890")}


def normalize_zh(text: str) -> str:
    """Rewrite non-standard words into hanzi readings (``text_norm.py``
    NSWNormalizer scope): fullwidth forms, dates, clock times, fractions,
    percents, decimals, ranges, phone numbers, years, cardinals."""
    text = text.translate(_FULLWIDTH)

    def _decimal(m):
        return num_to_hanzi(int(m.group(1))) + "点" + digits_to_hanzi(m.group(2))

    def _year(m):
        return digits_to_hanzi(m.group(1)) + "年"

    def _int(m):
        return num_to_hanzi(int(m.group(0)))

    def _date(m):
        y, mo, d = m.group(1), int(m.group(2)), int(m.group(3))
        return (digits_to_hanzi(y) + "年" + num_to_hanzi(mo) + "月" +
                num_to_hanzi(d) + "日")

    def _md(m):
        return num_to_hanzi(int(m.group(1))) + "月" + \
            num_to_hanzi(int(m.group(2))) + m.group(3)

    def _time(m):
        h, mi = int(m.group(1)), int(m.group(2))
        out = num_to_hanzi(h) + "点"
        if mi:
            out += ("零" if mi < 10 else "") + num_to_hanzi(mi) + "分"
        if m.group(3):
            out += num_to_hanzi(int(m.group(3))) + "秒"
        return out

    def _fraction(m):
        return num_to_hanzi(int(m.group(2))) + "分之" + \
            num_to_hanzi(int(m.group(1)))

    def _range(m):
        return num_to_hanzi(int(m.group(1))) + "到" + \
            num_to_hanzi(int(m.group(2)))

    def _phone(m):
        return digits_to_hanzi(re.sub(r"[-\s]", "", m.group(0)))

    # (?<![a-zA-Z]) keeps tone digits glued to pinyin ('ni3') intact
    text = re.sub(r"(?<![a-zA-Z\d])1[3-9]\d{9}(?!\d)", _phone, text)  # mobile
    text = re.sub(r"(?<![a-zA-Z\d])0\d{2,3}-\d{7,8}(?!\d)", _phone, text)
    text = re.sub(r"(?<![a-zA-Z])(\d{2,4})[-/年](\d{1,2})[-/月](\d{1,2})日?",
                  _date, text)
    text = re.sub(r"(?<![a-zA-Z\d])(\d{1,2})月(\d{1,2})(日|号)", _md, text)
    text = re.sub(r"(?<![a-zA-Z])(\d{1,2}):(\d{2})(?::(\d{2}))?(?!\d)",
                  _time, text)
    text = re.sub(r"(?<![a-zA-Z])(\d+)/(\d+)", _fraction, text)
    text = re.sub(r"(?<![a-zA-Z])(\d+)[~～](\d+)", _range, text)
    text = re.sub(r"(?<![a-zA-Z])(\d+(?:\.\d+)?)%", lambda m: "百分之" + (
        _decimal(re.match(r"(\d+)\.(\d+)", m.group(1)))
        if "." in m.group(1) else num_to_hanzi(int(m.group(1)))), text)
    text = re.sub(r"(?<![a-zA-Z])(\d+)\.(\d+)", _decimal, text)
    text = re.sub(r"(?<![a-zA-Z])(\d{4})年", _year, text)
    text = re.sub(r"(?<![a-zA-Z])\d+", _int, text)
    return text


# ---------------------------------------------------------------------------
# Pinyin utilities + frontend
# ---------------------------------------------------------------------------


def split_pinyin(syllable: str) -> list[str]:
    """'xiao3' → ['x', 'iao3']; 'ai4' → ['ai4'] (zero-initial)."""
    s = syllable.lower().strip()
    for ini in INITIALS:
        if s.startswith(ini) and len(s) > len(ini) and \
                not s[len(ini)].isdigit():
            return [ini, s[len(ini):]]
    return [s]


_BUNDLED_TSV = os.path.join(os.path.dirname(__file__), "data",
                            "zh_lexicon.tsv.gz")

# Phrase-level readings for common polyphone-bearing words (the behavior
# pypinyin's phrase dict gives the reference; applied longest-match-first
# before per-char lookup). "word": "syl1 syl2 ...".
_PHRASES = {
    # 乐 le4/yue4
    "音乐": "yin1 yue4", "乐器": "yue4 qi4", "乐队": "yue4 dui4",
    "乐曲": "yue4 qu3", "声乐": "sheng1 yue4", "器乐": "qi4 yue4",
    "快乐": "kuai4 le4", "欢乐": "huan1 le4", "可乐": "ke3 le4",
    "娱乐": "yu2 le4", "乐趣": "le4 qu4", "乐观": "le4 guan1",
    # 行 xing2/hang2
    "银行": "yin2 hang2", "行业": "hang2 ye4", "行列": "hang2 lie4",
    "同行": "tong2 hang2", "外行": "wai4 hang2", "内行": "nei4 hang2",
    # 长 chang2/zhang3
    "长大": "zhang3 da4", "成长": "cheng2 zhang3", "增长": "zeng1 zhang3",
    "长辈": "zhang3 bei4", "校长": "xiao4 zhang3", "家长": "jia1 zhang3",
    "队长": "dui4 zhang3", "部长": "bu4 zhang3", "市长": "shi4 zhang3",
    "生长": "sheng1 zhang3", "长老": "zhang3 lao3",
    # 重 zhong4/chong2
    "重复": "chong2 fu4", "重新": "chong2 xin1", "重庆": "chong2 qing4",
    "重叠": "chong2 die2",
    # 得 de2/de5
    "觉得": "jue2 de5", "记得": "ji4 de5", "显得": "xian3 de5",
    "值得": "zhi2 de5", "懂得": "dong3 de5", "舍不得": "she3 bu5 de5",
    # 了 le5/liao3
    "了解": "liao3 jie3", "了不起": "liao3 bu5 qi3",
    # 还 hai2/huan2
    "归还": "gui1 huan2", "还原": "huan2 yuan2", "还款": "huan2 kuan3",
    # 为 wei4/wei2
    "成为": "cheng2 wei2", "作为": "zuo4 wei2", "认为": "ren4 wei2",
    "以为": "yi3 wei2", "行为": "xing2 wei2", "为难": "wei2 nan2",
    # 发 fa1/fa4
    "头发": "tou2 fa4", "理发": "li3 fa4",
    # 干 gan1/gan4
    "干部": "gan4 bu4", "能干": "neng2 gan4", "干活": "gan4 huo2",
    "干劲": "gan4 jin4",
    # 教 jiao4/jiao1
    "教书": "jiao1 shu1", "教给": "jiao1 gei3",
    # 相 xiang1/xiang4
    "照相": "zhao4 xiang4", "相机": "xiang4 ji1", "相貌": "xiang4 mao4",
    # 都 dou1/du1
    "都市": "du1 shi4", "首都": "shou3 du1", "都城": "du1 cheng2",
    # 便 bian4/pian2
    "便宜": "pian2 yi2",
    # 调 tiao2/diao4
    "调查": "diao4 cha2", "声调": "sheng1 diao4", "调动": "diao4 dong4",
    # 传 chuan2/zhuan4
    "传记": "zhuan4 ji4", "自传": "zi4 zhuan4",
    # 处 chu4/chu3
    "处理": "chu3 li3", "处于": "chu3 yu2", "处罚": "chu3 fa2",
    "相处": "xiang1 chu3", "处境": "chu3 jing4",
    # 差 cha4/cha1/chai1
    "出差": "chu1 chai1", "差别": "cha1 bie2", "差距": "cha1 ju4",
    "差异": "cha1 yi4",
    # 觉 jue2/jiao4
    "睡觉": "shui4 jiao4", "午觉": "wu3 jiao4",
    # 降 jiang4/xiang2
    "投降": "tou2 xiang2",
    # 尽 jin4/jin3
    "尽量": "jin3 liang4", "尽管": "jin3 guan3",
    # 卷 juan3/juan4
    "试卷": "shi4 juan4", "考卷": "kao3 juan4",
    # 空 kong1/kong4
    "有空": "you3 kong4", "填空": "tian2 kong4", "空闲": "kong4 xian2",
    # 难 nan2/nan4
    "灾难": "zai1 nan4", "难民": "nan4 min2", "遇难": "yu4 nan4",
    # 宁 ning2/ning4
    "宁可": "ning4 ke3", "宁愿": "ning4 yuan4",
    # 强 qiang2/qiang3
    "强迫": "qiang3 po4", "勉强": "mian3 qiang3",
    # 曲 qu3/qu1
    "弯曲": "wan1 qu1", "曲线": "qu1 xian4", "曲折": "qu1 zhe2",
    # 散 san4/san3
    "散文": "san3 wen2", "散漫": "san3 man4",
    # 省 sheng3/xing3
    "反省": "fan3 xing3",
    # 似 si4/shi4
    "似的": "shi4 de5",
    # 提 ti2/di1
    "提防": "di1 fang2",
    # 挑 tiao1/tiao3
    "挑战": "tiao3 zhan4", "挑衅": "tiao3 xin4",
    # 吐 tu3/tu4
    "呕吐": "ou3 tu4",
    # 兴 xing4/xing1
    "兴奋": "xing1 fen4", "兴起": "xing1 qi3", "兴旺": "xing1 wang4",
    # 要 yao4/yao1
    "要求": "yao1 qiu2",
    # 应 ying1/ying4
    "答应": "da1 ying4", "应用": "ying4 yong4", "反应": "fan3 ying4",
    "适应": "shi4 ying4", "应付": "ying4 fu4",
    # 载 zai4/zai3
    "记载": "ji4 zai3",
    # 正 zheng4/zheng1
    "正月": "zheng1 yue4",
    # 中 zhong1/zhong4
    "中奖": "zhong4 jiang3", "打中": "da3 zhong4", "中毒": "zhong4 du2",
    # 种 zhong3/zhong4
    "种植": "zhong4 zhi2", "种地": "zhong4 di4", "种树": "zhong4 shu4",
    # 钻 zuan1/zuan4
    "钻石": "zuan4 shi2",
    # 背 bei4/bei1
    "背包": "bei1 bao1", "背负": "bei1 fu4",
    # 藏 cang2/zang4
    "西藏": "xi1 zang4", "宝藏": "bao3 zang4",
    # 弹 tan2/dan4
    "子弹": "zi3 dan4", "炸弹": "zha4 dan4", "导弹": "dao3 dan4",
    # 当 dang1/dang4
    "上当": "shang4 dang4", "适当": "shi4 dang4", "当作": "dang4 zuo4",
    # 倒 dao3/dao4
    "倒是": "dao4 shi4", "倒影": "dao4 ying3", "倒退": "dao4 tui4",
    # 斗 dou4/dou3
    "北斗": "bei3 dou3", "斗篷": "dou3 peng5",
    # 分 fen1/fen4
    "部分": "bu4 fen4", "成分": "cheng2 fen4", "分量": "fen4 liang4",
    "充分": "chong1 fen4",
    # 更 geng4/geng1
    "更新": "geng1 xin1", "更换": "geng1 huan4", "更正": "geng1 zheng4",
    # 会 hui4/kuai4
    "会计": "kuai4 ji4",
    # 假 jia3/jia4
    "假期": "jia4 qi1", "放假": "fang4 jia4", "请假": "qing3 jia4",
    "暑假": "shu3 jia4", "寒假": "han2 jia4", "度假": "du4 jia4",
    # 间 jian1/jian4
    "间接": "jian4 jie1", "间隔": "jian4 ge2", "间谍": "jian4 die2",
    # 将 jiang1/jiang4
    "麻将": "ma2 jiang4", "大将": "da4 jiang4",
    # 看 kan4/kan1
    "看守": "kan1 shou3", "看护": "kan1 hu4",
    # 累 lei4/lei3
    "积累": "ji1 lei3", "累计": "lei3 ji4",
    # 漂 piao4/piao1
    "漂浮": "piao1 fu2", "漂流": "piao1 liu2",
    # 切 qie1/qie4
    "一切": "yi1 qie4", "密切": "mi4 qie4", "亲切": "qin1 qie4",
    # 塞 sai1/se4/sai4
    "堵塞": "du3 se4", "要塞": "yao4 sai4",
    # 挣 zheng4/zheng1
    "挣扎": "zheng1 zha2",
    # 仔 zai3/zi3
    "仔细": "zi3 xi4",
    # 角 jiao3/jue2
    "角色": "jue2 se4", "主角": "zhu3 jue2", "配角": "pei4 jue2",
    # 壳 ke2/qiao4
    "地壳": "di4 qiao4",
    # 模 mo2/mu2
    "模样": "mu2 yang4", "模具": "mu2 ju4",
    # 铺 pu1/pu4
    "店铺": "dian4 pu4", "床铺": "chuang2 pu4", "铺位": "pu4 wei4",
    # 率 lv4/shuai4
    "率领": "shuai4 ling3", "率先": "shuai4 xian1",
    # 咽 yan4/yan1
    "咽喉": "yan1 hou2",
    # 晕 yun1/yun4
    "晕车": "yun4 che1", "晕船": "yun4 chuan2",
    # 只 zhi3/zhi1
    "一只": "yi1 zhi1", "两只": "liang3 zhi1", "几只": "ji3 zhi1",
}
_MAX_PHRASE = max(len(k) for k in _PHRASES)


def phrase_assignments(text: str) -> dict[int, str]:
    """Greedy longest-match scan: char index → phrase-assigned syllable for
    every position covered by a ``_PHRASES`` entry."""
    out: dict[int, str] = {}
    i, n = 0, len(text)
    while i < n:
        for ln in range(min(_MAX_PHRASE, n - i), 1, -1):
            word = text[i: i + ln]
            if word in _PHRASES:
                for j, syl in enumerate(_PHRASES[word].split()):
                    out[i + j] = syl
                i += ln
                break
        else:
            i += 1
    return out


class PinyinLexicon:
    """hanzi → 'syllable+tone'. Load order (later wins): bundled CLDR-derived
    TSV (19.5k chars) → curated builtin (polyphone context-free defaults) →
    optional user TSV."""

    def __init__(self, path: str | None = None, bundled: bool = True):
        self.table: dict[str, str] = {}
        if bundled and os.path.exists(_BUNDLED_TSV):
            self._load(_BUNDLED_TSV)
        self.table.update(_BUILTIN_LEXICON)
        if path:
            self._load(path)

    def _load(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    self.table[parts[0]] = parts[1].replace(" ", "")

    def __call__(self, char: str) -> str | None:
        return self.table.get(char)


class ZhFrontend:
    """text (hanzi and/or pinyin syllables) → phones with ``|`` separators.

    Matches the reference zh processor's output scheme: per character,
    ``initial final+tone`` (tone 1-5 digit on the final), punctuation kept,
    unknown hanzi dropped with a ``<UNK>``.
    """

    PUNCS = "!,.?;:、。！，？；："

    def __init__(self, lexicon: PinyinLexicon | None = None,
                 oov: str = "unk"):
        """``oov``: out-of-lexicon hanzi policy — ``'unk'`` emits ``<UNK>``
        (default, matches round-1 behavior), ``'skip'`` drops the char,
        ``'raise'`` raises ``KeyError`` (strict data pipelines)."""
        if oov not in ("unk", "skip", "raise"):
            raise ValueError(f"oov policy {oov!r}")
        self.lexicon = lexicon or PinyinLexicon()
        self.oov = oov

    def _oov(self, char: str) -> list[str]:
        if self.oov == "raise":
            raise KeyError(f"hanzi {char!r} (U+{ord(char):04X}) not in "
                           "pinyin lexicon")
        return [] if self.oov == "skip" else ["<UNK>"]

    def __call__(self, text: str) -> list[str]:
        text = normalize_zh(text)
        phrase = phrase_assignments(text)
        phones: list[str] = []

        def sep():
            if phones and phones[-1] != "|":
                phones.append("|")

        # pre-split latin pinyin runs; finditer keeps positions for the
        # phrase-level polyphone assignments
        for m in re.finditer(r"[a-zA-Z]+\d?|.", text):
            token = m.group(0)
            if re.fullmatch(r"[a-zA-Z]+\d?", token):
                phones.extend(split_pinyin(token))
                sep()
            elif token in self.PUNCS:
                phones.append(token if token in "!,.?;:" else
                              {"、": ",", "。": ".", "！": "!", "，": ",",
                               "？": "?", "；": ";", "：": ":"}[token])
                sep()
            elif token.strip() == "":
                sep()
            else:
                py = phrase.get(m.start()) or self.lexicon(token)
                phones.extend(self._oov(token) if py is None
                              else split_pinyin(py))
                sep()
        if phones and phones[-1] == "|":
            phones.pop()
        return phones


class ZhTTSFrontend(ZhFrontend):
    """Binarizer-compatible Chinese frontend: callable → ``ProcessedText``
    (the reference's zh txt processor emits char-level words with ``|``
    boundaries — ``data_gen/tts/txt_processors/zh.py``). Words are hanzi
    characters / pinyin syllables / punctuation; phones carry the ``|``
    word-boundary markers exactly like the English frontend so
    ``TTSBinarizer`` (and the word-level PortaSpeech fields) work unchanged.
    """

    def __init__(self, lexicon: PinyinLexicon | None = None,
                 phone_encoder=None, oov: str = "unk"):
        super().__init__(lexicon, oov=oov)
        self.phone_encoder = phone_encoder

    def __call__(self, text: str):
        from audiogpt_tpu_torch.text.frontend import ProcessedText

        norm = normalize_zh(text)
        phrase = phrase_assignments(norm)
        words: list[str] = []
        word_phs: list[list[str]] = []
        for m in re.finditer(r"[a-zA-Z]+\d?|.", norm):
            token = m.group(0)
            if re.fullmatch(r"[a-zA-Z]+\d?", token):
                words.append(token)
                word_phs.append(split_pinyin(token))
            elif token in self.PUNCS:
                p = token if token in "!,.?;:" else \
                    {"、": ",", "。": ".", "！": "!", "，": ",",
                     "？": "?", "；": ";", "：": ":"}[token]
                words.append(p)
                word_phs.append([p])
            elif token.strip() == "":
                continue
            else:
                py = phrase.get(m.start()) or self.lexicon(token)
                phs = split_pinyin(py) if py else self._oov(token)
                if not phs:          # oov='skip'
                    continue
                words.append(token)
                word_phs.append(phs)
        phones: list[str] = []
        ph2word: list[int] = []
        for wi, phs in enumerate(word_phs, start=1):
            for p in phs:
                phones.append(p)
                ph2word.append(wi)
            phones.append("|")
            ph2word.append(wi)
        if phones and phones[-1] == "|":
            phones = phones[:-1]
            ph2word = ph2word[:-1]
        return ProcessedText(norm, words, phones, ph2word)
