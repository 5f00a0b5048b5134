"""SemanticKITTI label constants (counterpart of lidiff_tpu/data/data_map.py;
the dataset's standard tables).

Only `learning_map` is touched by the pipeline (and there only to decide
static vs moving: raw ids >= 252 are moving classes, <= 1 unlabeled); the
rest is provided for parity and visualization.
"""

LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LABELS = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking",
    70: "vegetation", 71: "trunk", 72: "terrain", 80: "pole",
    81: "traffic-sign", 99: "other-object", 252: "moving-car",
    253: "moving-bicyclist", 254: "moving-person",
    255: "moving-motorcyclist", 256: "moving-on-rails", 257: "moving-bus",
    258: "moving-truck", 259: "moving-other-vehicle",
}

COLOR_MAP_BGR = {
    0: [0, 0, 0], 1: [0, 0, 255], 10: [245, 150, 100], 11: [245, 230, 100],
    13: [250, 80, 100], 15: [150, 60, 30], 16: [255, 0, 0],
    18: [180, 30, 80], 20: [255, 0, 0], 30: [30, 30, 255],
    31: [200, 40, 255], 32: [90, 30, 150], 40: [255, 0, 255],
    44: [255, 150, 255], 48: [75, 0, 75], 49: [75, 0, 175],
    50: [0, 200, 255], 51: [50, 120, 255], 52: [0, 150, 255],
    60: [170, 255, 150], 70: [0, 175, 0], 71: [0, 60, 135],
    72: [80, 240, 150], 80: [150, 240, 255], 81: [0, 0, 255],
    99: [255, 255, 50], 252: [245, 150, 100], 253: [200, 40, 255],
    254: [30, 30, 255], 255: [90, 30, 150], 256: [255, 0, 0],
    257: [250, 80, 100], 258: [180, 30, 80], 259: [255, 0, 0],
}

MOVING_CLASS_START = 252     # raw ids >= this are moving (ref masks l < 252)
