// libgpuinfo: the native card probe of the node agents (the NVML slot).
//
// The counterpart of native/libtpuinfo.cpp. It gives the chip table that
// tpu_operator_torch/native/gpuinfo.py gives, field for field, from one of
// two backends:
//
//   * NVML, reached through dlopen of the driver's libnvidia-ml.so.1 (or
//     the path in NVML_LIBRARY) and dlsym of exactly the versioned entries
//     gpuinfo.NVML_SIGNATURES declares: a card's index is its minor number,
//     source "nvml", a field NVML does not answer is left out, and the
//     NUMA node, vendor and class are joined from sysfs on the PCI bus id;
//   * where NVML is missing or does not answer, the device nodes
//     (/dev/nvidiaN, else /dev/vfio/*), /proc/driver/nvidia/gpus/*/information
//     and sysfs's PCI tree, source "sysfs" (gpuinfo._sysfs_chips).
//
// The prototypes and structs of NVML are declared here by hand: no nvml.h
// is needed to build. The device, proc and sysfs roots are arguments (NULL
// or "" for the host's), so the table can be read from fixture trees.
//
// C ABI only; no exceptions across the boundary; the caller provides the
// buffers: -2 for a missing buffer, -3 for one too short (the caller
// retries with a larger one).

#include <dirent.h>
#include <dlfcn.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace {

const char* const kDevRoot = "/dev";
const char* const kProcGpus = "/proc/driver/nvidia/gpus";
const char* const kSysfsPci = "/sys/bus/pci/devices";
const char* const kNvmlName = "libnvidia-ml.so.1";
const char* const kCardVendor = "0x10de";

// ---------------------------------------------------------------------------
// NVML, declared by hand
// ---------------------------------------------------------------------------

typedef struct nvmlDevice_st* nvmlDevice_t;

struct nvmlPciInfo_t {  // nvmlPciInfo_t as nvmlDeviceGetPciInfo_v3 fills it
  char busIdLegacy[16];
  unsigned int domain;
  unsigned int bus;
  unsigned int device;
  unsigned int pciDeviceId;
  unsigned int pciSubSystemId;
  char busId[32];
};

struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};

struct nvmlUtilization_t {
  unsigned int gpu;
  unsigned int memory;
};

const int kNvmlSuccess = 0;
const int kNvmlTemperatureGpu = 0;
const unsigned kNameLen = 96;
const unsigned kUuidLen = 96;

struct Nvml {
  int (*Init_v2)();
  int (*Shutdown)();
  const char* (*ErrorString)(int);
  int (*SystemGetDriverVersion)(char*, unsigned);
  int (*DeviceGetCount_v2)(unsigned*);
  int (*DeviceGetHandleByIndex_v2)(unsigned, nvmlDevice_t*);
  int (*DeviceGetName)(nvmlDevice_t, char*, unsigned);
  int (*DeviceGetUUID)(nvmlDevice_t, char*, unsigned);
  int (*DeviceGetMinorNumber)(nvmlDevice_t, unsigned*);
  int (*DeviceGetPciInfo_v3)(nvmlDevice_t, nvmlPciInfo_t*);
  int (*DeviceGetPowerManagementLimit)(nvmlDevice_t, unsigned*);
  int (*DeviceGetMemoryInfo)(nvmlDevice_t, nvmlMemory_t*);
  int (*DeviceGetUtilizationRates)(nvmlDevice_t, nvmlUtilization_t*);
  int (*DeviceGetTemperature)(nvmlDevice_t, int, unsigned*);
  int (*DeviceGetMigMode)(nvmlDevice_t, unsigned*, unsigned*);
};

template <typename Fn>
bool resolve(void* handle, const char* name, Fn& fn) {
  fn = reinterpret_cast<Fn>(::dlsym(handle, name));
  return fn != nullptr;
}

// NVML from `path`, or nullptr where it does not load or lacks an entry.
// A library is opened once a process and path, and never closed.
const Nvml* nvml_at(const std::string& path) {
  static std::mutex mu;
  static std::map<std::string, const Nvml*> loaded;
  std::lock_guard<std::mutex> lock(mu);
  auto it = loaded.find(path);
  if (it != loaded.end()) return it->second;
  const Nvml* out = nullptr;
  void* h = ::dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (h) {
    Nvml* n = new Nvml();
    if (resolve(h, "nvmlInit_v2", n->Init_v2) && resolve(h, "nvmlShutdown", n->Shutdown) &&
        resolve(h, "nvmlErrorString", n->ErrorString) &&
        resolve(h, "nvmlSystemGetDriverVersion", n->SystemGetDriverVersion) &&
        resolve(h, "nvmlDeviceGetCount_v2", n->DeviceGetCount_v2) &&
        resolve(h, "nvmlDeviceGetHandleByIndex_v2", n->DeviceGetHandleByIndex_v2) &&
        resolve(h, "nvmlDeviceGetName", n->DeviceGetName) &&
        resolve(h, "nvmlDeviceGetUUID", n->DeviceGetUUID) &&
        resolve(h, "nvmlDeviceGetMinorNumber", n->DeviceGetMinorNumber) &&
        resolve(h, "nvmlDeviceGetPciInfo_v3", n->DeviceGetPciInfo_v3) &&
        resolve(h, "nvmlDeviceGetPowerManagementLimit", n->DeviceGetPowerManagementLimit) &&
        resolve(h, "nvmlDeviceGetMemoryInfo", n->DeviceGetMemoryInfo) &&
        resolve(h, "nvmlDeviceGetUtilizationRates", n->DeviceGetUtilizationRates) &&
        resolve(h, "nvmlDeviceGetTemperature", n->DeviceGetTemperature) &&
        resolve(h, "nvmlDeviceGetMigMode", n->DeviceGetMigMode)) {
      out = n;
    } else {
      delete n;
      ::dlclose(h);
    }
  }
  loaded[path] = out;
  return out;
}

// gpuinfo._load's order: NVML_LIBRARY where set, then the driver's name.
const Nvml* load_nvml() {
  const char* explicit_path = std::getenv("NVML_LIBRARY");
  if (explicit_path && *explicit_path) {
    if (const Nvml* n = nvml_at(explicit_path)) return n;
  }
  return nvml_at(kNvmlName);
}

// ---------------------------------------------------------------------------
// text, paths and JSON
// ---------------------------------------------------------------------------

bool is_space(char c) {  // str.strip()'s ASCII whitespace
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f' ||
         (c >= 0x1c && c <= 0x1f);
}

std::string strip(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && is_space(s[b])) ++b;
  while (e > b && is_space(s[e - 1])) --e;
  return s.substr(b, e - b);
}

std::string lower(std::string s) {
  for (char& c : s)
    if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
  return s;
}

bool read_file(const std::string& path, std::string& out) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return false;
  out.clear();
  char buf[4096];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, n);
  std::fclose(f);
  return true;
}

// os.path.join(a, b) for a relative b
std::string join(const std::string& a, const std::string& b) {
  if (a.empty() || a.back() == '/') return a + b;
  return a + "/" + b;
}

bool all_digits(const std::string& s, size_t from = 0) {
  if (from >= s.size()) return false;
  for (size_t i = from; i < s.size(); ++i)
    if (s[i] < '0' || s[i] > '9') return false;
  return true;
}

// int(s) of a stripped decimal: a sign, then digits with single
// underscores between them
bool parse_int(const std::string& s, long long& out) {
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  long long v = 0;
  bool digit = false;
  for (; i < s.size(); ++i) {
    if (s[i] == '_' && digit && i + 1 < s.size() && s[i + 1] != '_') continue;
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
    digit = true;
  }
  if (!digit) return false;
  out = neg ? -v : v;
  return true;
}

// gpuinfo.normalize_bus_id: "00000000:BB:DD.F" as sysfs spells it,
// "0000:bb:dd.f"; false where it has no domain to read
bool normalize_bus_id(const std::string& raw, std::string& out) {
  std::string s = lower(strip(raw));
  size_t colon = s.find(':');
  if (colon == std::string::npos) return false;
  std::string dom = strip(s.substr(0, colon));
  if (dom.size() > 2 && dom[0] == '0' && dom[1] == 'x') dom = dom.substr(2);
  if (dom.empty() || dom.size() > 15) return false;
  unsigned long long v = 0;
  for (char c : dom) {
    int d = (c >= '0' && c <= '9') ? c - '0' : (c >= 'a' && c <= 'f') ? c - 'a' + 10 : -1;
    if (d < 0) return false;
    v = v * 16 + (unsigned)d;
  }
  char head[32];
  std::snprintf(head, sizeof(head), "%04llx", v);
  out = std::string(head) + s.substr(colon);
  return true;
}

std::string json_string(const std::string& s) {
  std::string out = "\"";
  for (unsigned char ch : s) {
    if (ch == '"' || ch == '\\') {
      out += '\\';
      out += (char)ch;
    } else if (ch < 0x20) {
      char esc[8];
      std::snprintf(esc, sizeof(esc), "\\u%04x", ch);
      out += esc;
    } else {
      out += (char)ch;
    }
  }
  return out + "\"";
}

// A card as an ordered dict of JSON values: set() replaces a key in place or
// appends it, as dict.update does.
struct Card {
  long long index = 0;
  std::vector<std::pair<std::string, std::string>> fields;

  void set(const std::string& key, const std::string& json) {
    for (auto& kv : fields)
      if (kv.first == key) {
        kv.second = json;
        return;
      }
    fields.emplace_back(key, json);
  }
  const std::string* get(const std::string& key) const {
    for (const auto& kv : fields)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  std::string json() const {
    std::string out = "{";
    for (size_t i = 0; i < fields.size(); ++i) {
      if (i) out += ",";
      out += json_string(fields[i].first) + ":" + fields[i].second;
    }
    return out + "}";
  }
};

// gpuinfo._py_pci_info: vendor, class and NUMA node of one function, each
// where it reads
void join_pci_info(Card& card, const std::string& pci, const std::string& sysfs) {
  std::string dir = join(sysfs, pci), text;
  if (read_file(join(dir, "vendor"), text)) card.set("vendor", json_string(strip(text)));
  if (read_file(join(dir, "class"), text)) card.set("pci_class", json_string(strip(text)));
  long long numa;
  if (read_file(join(dir, "numa_node"), text) && parse_int(strip(text), numa))
    card.set("numa_node", std::to_string(numa));
}

void sort_by_index(std::vector<Card>& cards) {
  std::stable_sort(cards.begin(), cards.end(),
                   [](const Card& a, const Card& b) { return a.index < b.index; });
}

// ---------------------------------------------------------------------------
// the NVML path (gpuinfo._nvml_chips)
// ---------------------------------------------------------------------------

// Every card NVML sees; false where NVML does not answer (init, count, or a
// card's handle, name or minor number), and the sysfs path answers instead.
bool nvml_cards(const Nvml& nv, const std::string& dev_root, const std::string& sysfs,
                std::vector<Card>& cards) {
  if (nv.Init_v2() != kNvmlSuccess) return false;
  bool ok = true;
  unsigned count = 0;
  if (nv.DeviceGetCount_v2(&count) != kNvmlSuccess) ok = false;
  for (unsigned i = 0; ok && i < count; ++i) {
    nvmlDevice_t h = nullptr;
    char name[kNameLen] = {0}, uuid[kUuidLen] = {0};
    unsigned minor = 0;
    if (nv.DeviceGetHandleByIndex_v2(i, &h) != kNvmlSuccess ||
        nv.DeviceGetName(h, name, kNameLen) != kNvmlSuccess ||
        nv.DeviceGetMinorNumber(h, &minor) != kNvmlSuccess) {
      ok = false;
      break;
    }
    name[kNameLen - 1] = '\0';
    Card card;
    card.index = minor;
    card.set("index", std::to_string(minor));
    card.set("path", json_string(join(dev_root, "nvidia" + std::to_string(minor))));
    card.set("name", json_string(name));
    card.set("source", json_string("nvml"));
    // a field NVML does not answer (NOT_SUPPORTED under gVisor) is left
    // out, as _nvml_card's answered() does
    nvmlPciInfo_t pci;
    std::memset(&pci, 0, sizeof(pci));
    std::string bus;
    if (nv.DeviceGetPciInfo_v3(h, &pci) == kNvmlSuccess && pci.busId[0]) {
      pci.busId[sizeof(pci.busId) - 1] = '\0';
      if (normalize_bus_id(pci.busId, bus)) card.set("pci_address", json_string(bus));
    }
    if (nv.DeviceGetUUID(h, uuid, kUuidLen) == kNvmlSuccess) {
      uuid[kUuidLen - 1] = '\0';
      card.set("uuid", json_string(uuid));
    }
    unsigned limit = 0, temp = 0, mig = 0, mig_pending = 0;
    nvmlMemory_t mem{};
    nvmlUtilization_t util{};
    if (nv.DeviceGetPowerManagementLimit(h, &limit) == kNvmlSuccess)
      card.set("power_limit_mw", std::to_string(limit));
    if (nv.DeviceGetMemoryInfo(h, &mem) == kNvmlSuccess) {
      card.set("memory_total_bytes", std::to_string(mem.total));
      card.set("memory_used_bytes", std::to_string(mem.used));
    }
    if (nv.DeviceGetUtilizationRates(h, &util) == kNvmlSuccess) {
      card.set("utilization_gpu", std::to_string(util.gpu));
      card.set("utilization_memory", std::to_string(util.memory));
    }
    if (nv.DeviceGetTemperature(h, kNvmlTemperatureGpu, &temp) == kNvmlSuccess)
      card.set("temperature_c", std::to_string(temp));
    if (nv.DeviceGetMigMode(h, &mig, &mig_pending) == kNvmlSuccess) {
      card.set("mig_mode", std::to_string(mig));
      card.set("mig_mode_pending", std::to_string(mig_pending));
    }
    if (!bus.empty()) join_pci_info(card, bus, sysfs);
    cards.push_back(std::move(card));
  }
  nv.Shutdown();
  if (!ok) {
    cards.clear();
    return false;
  }
  sort_by_index(cards);
  return true;
}

// ---------------------------------------------------------------------------
// the sysfs path (gpuinfo._sysfs_chips)
// ---------------------------------------------------------------------------

std::vector<std::string> list_dir(const std::string& dir) {
  std::vector<std::string> names;
  DIR* d = ::opendir(dir.c_str());
  if (!d) return names;
  while (dirent* e = ::readdir(d))
    if (e->d_name[0] != '.') names.push_back(e->d_name);  // glob skips dot files
  ::closedir(d);
  std::sort(names.begin(), names.end());
  return names;
}

// "nvidia<digits>": a card's node, not nvidiactl, nvidia-uvm or nvidia0foo
bool is_card_node(const std::string& name) {
  return name.compare(0, 6, "nvidia") == 0 && all_digits(name, 6);
}

// gpuinfo.find_gpu_devices: the card nodes, else the vfio groups
std::vector<std::string> find_devices(const std::string& dev_root) {
  std::vector<std::string> out;
  for (const auto& name : list_dir(dev_root))
    if (is_card_node(name)) out.push_back(join(dev_root, name));
  if (!out.empty()) return out;
  std::string vfio = join(dev_root, "vfio");
  for (const auto& name : list_dir(vfio))
    if (name != "vfio") out.push_back(join(vfio, name));
  return out;
}

std::string basename(const std::string& path) {
  size_t slash = path.find_last_of('/');
  return slash == std::string::npos ? path : path.substr(slash + 1);
}

// Stable ids: a node's numeric suffix (nvidiaN's minor number, a vfio
// group's number), never its position. The whole name must parse; names
// that do not get ids past the largest parsed one, so they can never shadow
// a real card (libtpuinfo.cpp's stable_ids).
std::vector<long long> stable_ids(const std::vector<std::string>& paths) {
  std::vector<long long> ids(paths.size(), -1);
  std::vector<bool> parsed(paths.size(), false);
  long long max_parsed = -1;
  for (size_t i = 0; i < paths.size(); ++i) {
    std::string name = basename(paths[i]);
    size_t from = is_card_node(name) ? 6 : 0;
    long long v;
    if (all_digits(name, from) && parse_int(name.substr(from), v)) {
      ids[i] = v;
      parsed[i] = true;
      max_parsed = std::max(max_parsed, v);
    }
  }
  long long next = max_parsed;
  for (size_t i = 0; i < paths.size(); ++i)
    if (!parsed[i]) ids[i] = ++next;
  return ids;
}

struct ProcCard {
  std::string pci, name, uuid;
};

// {minor: identity} from each card's /proc/driver/nvidia/gpus/<bus>/information
std::map<long long, ProcCard> proc_cards(const std::string& proc_root) {
  std::vector<std::string> infos;
  for (const auto& name : list_dir(proc_root)) {
    std::string info = join(join(proc_root, name), "information");
    struct stat st;
    if (::lstat(info.c_str(), &st) == 0) infos.push_back(info);
  }
  std::sort(infos.begin(), infos.end());  // glob's sorted() is of the whole path
  std::map<long long, ProcCard> out;
  for (const auto& info : infos) {
    std::string text;
    if (!read_file(info, text)) continue;
    std::map<std::string, std::string> fields;
    size_t pos = 0;
    while (pos < text.size()) {
      size_t end = text.find_first_of("\r\n", pos);
      if (end == std::string::npos) end = text.size();
      std::string line = text.substr(pos, end - pos);
      pos = end + 1;
      if (end < text.size() && text[end] == '\r' && pos < text.size() && text[pos] == '\n') ++pos;
      size_t colon = line.find(':');
      if (colon != std::string::npos)
        fields[strip(line.substr(0, colon))] = strip(line.substr(colon + 1));
    }
    auto minor_it = fields.find("Device Minor");
    long long minor;
    if (minor_it == fields.end() || !parse_int(minor_it->second, minor)) continue;
    std::string bus = fields.count("Bus Location") ? fields["Bus Location"] : "";
    if (bus.empty()) bus = basename(info.substr(0, info.size() - std::strlen("/information")));
    ProcCard card;
    if (!normalize_bus_id(bus, card.pci)) continue;
    card.name = fields.count("Model") ? fields["Model"] : "";
    card.uuid = fields.count("GPU UUID") ? fields["GPU UUID"] : "";
    out[minor] = card;
  }
  return out;
}

bool is_card_function(const std::string& vendor, const std::string& pci_class) {
  std::string c = lower(strip(pci_class));
  return lower(strip(vendor)) == kCardVendor &&
         (c.compare(0, 6, "0x0300") == 0 || c.compare(0, 6, "0x0302") == 0);
}

std::vector<Card> sysfs_cards(const std::string& dev_root, const std::string& proc_root,
                              const std::string& sysfs) {
  std::vector<std::string> devs = find_devices(dev_root);
  std::vector<long long> ids = stable_ids(devs);
  std::map<long long, ProcCard> proc = proc_cards(proc_root);
  std::vector<Card> cards;
  for (size_t i = 0; i < devs.size(); ++i) {
    Card card;
    card.index = ids[i];
    card.set("index", std::to_string(ids[i]));
    card.set("path", json_string(devs[i]));
    card.set("source", json_string("sysfs"));
    auto it = is_card_node(basename(devs[i])) ? proc.find(ids[i]) : proc.end();
    if (it != proc.end()) {
      const ProcCard& pc = it->second;
      card.set("pci_address", json_string(pc.pci));
      if (!pc.name.empty()) card.set("name", json_string(pc.name));
      if (!pc.uuid.empty()) card.set("uuid", json_string(pc.uuid));
      std::string dir = join(sysfs, pc.pci), vendor, pci_class;
      bool have_vendor = read_file(join(dir, "vendor"), vendor);
      bool have_class = read_file(join(dir, "class"), pci_class);
      join_pci_info(card, pc.pci, sysfs);
      if (have_vendor && have_class && !is_card_function(vendor, pci_class)) continue;
    }
    cards.push_back(std::move(card));
  }
  sort_by_index(cards);
  return cards;
}

// ---------------------------------------------------------------------------
// the probe's surface
// ---------------------------------------------------------------------------

std::string or_default(const char* s, const char* fallback) {
  return s && *s ? s : fallback;
}

// gpuinfo.chip_summary: NVML where it answers, else the sysfs path
std::vector<Card> chip_table(const char* dev_root, const char* proc_root, const char* sysfs) {
  std::string dev = or_default(dev_root, kDevRoot);
  std::string proc = or_default(proc_root, kProcGpus);
  std::string pci = or_default(sysfs, kSysfsPci);
  std::vector<Card> cards;
  if (const Nvml* nv = load_nvml()) {
    if (nvml_cards(*nv, dev, pci, cards)) return cards;
  }
  return sysfs_cards(dev, proc, pci);
}

int emit(const std::string& json, char* buf, int buf_len) {
  if (!buf || buf_len <= 0) return -2;
  if (json.size() + 1 > (size_t)buf_len) return -3;
  std::memcpy(buf, json.c_str(), json.size() + 1);
  return 0;
}

}  // namespace

extern "C" {

// Number of cards in the chip table.
int gpuinfo_chip_count(const char* dev_root, const char* proc_root, const char* sysfs) {
  return (int)chip_table(dev_root, proc_root, sysfs).size();
}

// The chip table as a JSON array, gpuinfo.chip_summary's shape: [{"index":
// <minor>,"path":...,"source":"nvml"|"sysfs",...}]. 0, or -2/-3 on a missing
// or short buffer.
int gpuinfo_summary_json(const char* dev_root, const char* proc_root, const char* sysfs,
                         char* buf, int buf_len) {
  std::string out = "[";
  auto cards = chip_table(dev_root, proc_root, sysfs);
  for (size_t i = 0; i < cards.size(); ++i) out += (i ? "," : "") + cards[i].json();
  return emit(out + "]", buf, buf_len);
}

// Telemetry for file-based readers: the metrics hostengine's drop file
// verbatim where `drop_file` holds a JSON object, else gpuinfo.metrics's
// shape over the chip table ({"source":..., "chips": [{"index", "present":
// 1, NVML's counters where they answer}]}). gpuinfo.native_metrics binds it;
// gpuinfo.metrics computes the same counters in Python and does not call
// it. 0, or -2/-3 on a missing or short buffer.
int gpuinfo_metrics_json(const char* dev_root, const char* proc_root, const char* sysfs,
                         const char* drop_file, char* buf, int buf_len) {
  std::string text;
  if (drop_file && *drop_file && read_file(drop_file, text)) {
    text = strip(text);
    if (!text.empty() && text.front() == '{') return emit(text, buf, buf_len);
  }
  auto cards = chip_table(dev_root, proc_root, sysfs);
  std::string source = cards.empty() ? "\"sysfs\"" : *cards[0].get("source");
  std::string out = "{\"source\":" + source + ",\"chips\":[";
  static const char* const counters[] = {"utilization_gpu", "utilization_memory",
                                         "memory_used_bytes", "power_limit_mw", "temperature_c"};
  for (size_t i = 0; i < cards.size(); ++i) {
    Card entry;
    entry.set("index", std::to_string(cards[i].index));
    entry.set("present", "1");
    for (const char* key : counters)
      if (const std::string* v = cards[i].get(key)) entry.set(key, *v);
    out += (i ? "," : "") + entry.json();
  }
  return emit(out + "]}", buf, buf_len);
}

// Liveness (not existence) of one device node: open and close it read-only
// and non-blocking. 0 healthy; 1 busy but alive (EBUSY: a client holds it,
// which proves the driver path works; EPERM/EACCES: the device cgroup denied
// the caller, which says nothing about the card); -errno otherwise (ENOENT,
// ENXIO, EIO: gone or wedged). A path under /vfio/ is stat'ed only: a VFIO
// group allows one open file, and a probe's open could race the VM
// launcher's.
int gpuinfo_device_probe_path(const char* path) {
  if (!path || !*path) return -EINVAL;
  if (std::strstr(path, "/vfio/") != nullptr) {
    struct stat st;
    return ::stat(path, &st) == 0 ? 0 : -errno;
  }
  int fd = ::open(path, O_RDONLY | O_NONBLOCK | O_CLOEXEC);
  if (fd >= 0) {
    ::close(fd);
    return 0;
  }
  if (errno == EBUSY || errno == EPERM || errno == EACCES) return 1;
  return -errno;
}

}  // extern "C"
