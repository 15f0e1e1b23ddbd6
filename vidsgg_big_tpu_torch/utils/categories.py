"""Category vocabularies for VidVRD and VidOR.

These are dataset facts (label-name <-> id mappings) shared with the reference
implementation (see reference utils/categories_v2.py); index 0 is always
``__background__``.  The PKU ordering is the alternative entity-id order used
by the PKU ("Beyond Short-Term Snippet") tracklets.
"""

VIDVRD_ENTITIES = [
    "__background__",
    "airplane", "antelope", "bear", "bicycle",
    "bird", "bus", "car", "cattle",
    "dog", "domestic_cat", "elephant", "fox",
    "giant_panda", "hamster", "horse", "lion",
    "lizard", "monkey", "motorcycle", "rabbit",
    "red_panda", "sheep", "snake", "squirrel",
    "tiger", "train", "turtle", "watercraft",
    "whale", "zebra",
    "ball", "frisbee", "sofa", "skateboard", "person",
]

PKU_VIDVRD_ENTITIES = [
    "__background__", "lion", "bear", "domestic_cat", "elephant",
    "motorcycle", "giant_panda", "frisbee",
    "watercraft", "bicycle", "train", "zebra",
    "antelope", "turtle", "bus", "sofa", "airplane",
    "bird", "monkey", "cattle", "tiger", "dog", "squirrel",
    "rabbit", "car", "snake", "hamster", "lizard", "whale",
    "red_panda", "fox", "person", "ball", "sheep", "skateboard", "horse",
]

VIDVRD_PREDICATES = [
    "__background__",
    "taller", "swim_behind", "walk_away", "fly_behind", "creep_behind",
    "lie_with", "move_left", "stand_next_to", "touch", "follow",
    "move_away", "lie_next_to", "walk_with", "move_next_to", "creep_above",
    "stand_above", "fall_off", "run_with", "swim_front", "walk_next_to",
    "kick", "stand_left", "creep_right", "sit_above", "watch",
    "swim_with", "fly_away", "creep_beneath", "front", "run_past",
    "jump_right", "fly_toward", "stop_beneath", "stand_inside", "creep_left",
    "run_next_to", "beneath", "stop_left", "right", "jump_front",
    "jump_beneath", "past", "jump_toward", "sit_front", "sit_inside",
    "walk_beneath", "run_away", "stop_right", "run_above", "walk_right",
    "away", "move_right", "fly_right", "behind", "sit_right",
    "above", "run_front", "run_toward", "jump_past", "stand_with",
    "sit_left", "jump_above", "move_with", "swim_beneath", "stand_behind",
    "larger", "walk_past", "stop_front", "run_right", "creep_away",
    "move_toward", "feed", "run_left", "lie_beneath", "fly_front",
    "walk_behind", "stand_beneath", "fly_above", "bite", "fly_next_to",
    "stop_next_to", "fight", "walk_above", "jump_behind", "fly_with",
    "sit_beneath", "sit_next_to", "jump_next_to", "run_behind", "move_behind",
    "swim_right", "swim_next_to", "hold", "move_past", "pull",
    "stand_front", "walk_left", "lie_above", "ride", "next_to",
    "move_beneath", "lie_behind", "toward", "jump_left", "stop_above",
    "creep_toward", "lie_left", "fly_left", "stop_with", "walk_toward",
    "stand_right", "chase", "creep_next_to", "fly_past", "move_front",
    "run_beneath", "creep_front", "creep_past", "play", "lie_inside",
    "stop_behind", "move_above", "sit_behind", "faster", "lie_right",
    "walk_front", "drive", "swim_left", "jump_away", "jump_with",
    "lie_front", "left",
]

VIDOR_ENTITIES = [
    "__background__",
    "bread", "cake", "dish", "fruits", "vegetables", "crab",
    "backpack", "camera", "cellphone", "handbag", "laptop", "suitcase",
    "ball/sports_ball", "bat", "frisbee", "racket", "skateboard", "ski",
    "snowboard", "surfboard", "toy", "baby_seat", "bottle", "chair", "cup",
    "electric_fan", "faucet", "microwave", "oven", "refrigerator",
    "screen/monitor", "sink", "sofa", "stool", "table", "toilet",
    "guitar", "piano", "baby_walker", "bench", "stop_sign", "traffic_light",
    "aircraft", "bicycle", "bus/truck", "car", "motorcycle", "scooter",
    "train", "watercraft", "bird", "chicken", "duck", "penguin", "fish",
    "stingray", "crocodile", "snake", "turtle", "antelope", "bear", "camel",
    "cat", "cattle/cow", "dog", "elephant", "hamster/rat", "horse",
    "kangaroo", "leopard", "lion", "panda", "pig", "rabbit", "sheep/goat",
    "squirrel", "tiger", "adult", "baby", "child",
]

VIDOR_PREDICATES = [
    "__background__",
    "bite", "caress", "carry", "chase", "clean", "close", "cut", "drive",
    "feed", "get_off", "get_on", "grab", "hit", "hold", "hold_hand_of",
    "hug", "kick", "kiss", "knock", "lean_on", "lick", "lift", "open",
    "pat", "play(instrument)", "point_to", "press", "pull", "push",
    "release", "ride", "shake_hand_with", "shout_at", "smell", "speak_to",
    "squeeze", "throw", "touch", "use", "watch", "wave", "wave_hand_to",
    "above", "away", "behind", "beneath", "in_front_of", "inside",
    "next_to", "towards",
]


def _id2name(names):
    return {i: n for i, n in enumerate(names)}


def _name2id(names):
    return {n: i for i, n in enumerate(names)}


vidvrd_CatId2name = _id2name(VIDVRD_ENTITIES)
vidvrd_CatName2Id = _name2id(VIDVRD_ENTITIES)
PKU_vidvrd_CatId2name = _id2name(PKU_VIDVRD_ENTITIES)
PKU_vidvrd_CatName2Id = _name2id(PKU_VIDVRD_ENTITIES)
vidvrd_PredId2name = _id2name(VIDVRD_PREDICATES)
vidvrd_PredName2Id = _name2id(VIDVRD_PREDICATES)
vidor_CatId2name = _id2name(VIDOR_ENTITIES)
vidor_CatName2Id = _name2id(VIDOR_ENTITIES)
vidor_PredId2name = _id2name(VIDOR_PREDICATES)
vidor_PredName2Id = _name2id(VIDOR_PREDICATES)

NUM_ENTITIES = {"vidvrd": len(VIDVRD_ENTITIES), "vidor": len(VIDOR_ENTITIES)}
NUM_PREDICATES = {
    "vidvrd": len(VIDVRD_PREDICATES),
    "vidor": len(VIDOR_PREDICATES),
}


def get_vocab(dataset_type: str, use_pku: bool = False):
    """Return (entity_id2name, predicate_id2name) for a dataset."""
    d = dataset_type.lower()
    if d == "vidvrd":
        ent = PKU_vidvrd_CatId2name if use_pku else vidvrd_CatId2name
        return ent, vidvrd_PredId2name
    if d == "vidor":
        return vidor_CatId2name, vidor_PredId2name
    raise ValueError(f"unknown dataset_type: {dataset_type}")
